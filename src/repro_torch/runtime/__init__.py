from repro_torch.runtime.invocation import Invocation


def __getattr__(name):  # lazy: avoid core<->runtime import cycle
    if name in ('Simulation', 'SimResult', 'run_sim'):
        from repro_torch.runtime import simulate
        return getattr(simulate, name)
    raise AttributeError(name)
