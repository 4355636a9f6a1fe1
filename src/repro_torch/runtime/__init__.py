from repro_torch.runtime.invocation import Invocation
