from repro_torch.workloads.spec import FunctionSpec, PAPER_FUNCTIONS, function_copies, DEFAULT_MIX
from repro_torch.workloads.traces import (TraceEvent, zipf_trace, azure_trace,
                                    make_workload, zipf_stream, azure_stream,
                                    merge_streams)
# scenarios and the Azure loader (repro.workloads.scenarios /
# azure_loader) wait for ROADMAP.md section 1, item 17
