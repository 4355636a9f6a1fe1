from repro_torch.workloads.spec import FunctionSpec, PAPER_FUNCTIONS, function_copies, DEFAULT_MIX
