from repro_torch.workloads.spec import FunctionSpec, PAPER_FUNCTIONS, function_copies, DEFAULT_MIX
from repro_torch.workloads.traces import (TraceEvent, zipf_trace, azure_trace,
                                    make_workload, zipf_stream, azure_stream,
                                    merge_streams)
from repro_torch.workloads.scenarios import SCENARIOS, Scenario, make_scenario
from repro_torch.workloads.azure_loader import (AzureRow, counts_stream,
                                          iter_azure_rows,
                                          load_azure_scenario,
                                          synthetic_azure_rows)
