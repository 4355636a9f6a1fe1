"""Deprecation shim over ``repro.server`` (the unified control plane).

The discrete-event simulator now lives in ``repro.server``: the control
plane (policy + memory + warm pool + fairness + D-tokens) is
``repro.server.control.ControlPlane`` and the virtual-clock event loop
is ``repro.server.executors.SimExecutor``. This module keeps the
historical entry points — ``run_sim``, ``Simulation``, ``SimResult``,
``SimDevice`` — for existing call sites; new code should use::

    from repro_torch.server import ServerConfig, make_server
    res = make_server(ServerConfig(...), fns=fns).run_trace(trace)
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.policy_base import Policy
from repro_torch.server.config import ServerConfig, make_server
from repro_torch.server.control import DeviceState as SimDevice  # noqa: F401
from repro_torch.server.metrics import RunResult as SimResult  # noqa: F401
from repro_torch.workloads.spec import FunctionSpec
from repro_torch.workloads.traces import TraceEvent


class Simulation:
    """Legacy wrapper: ``Simulation(policy, fns, trace, **kw).run()``.
    ``kw`` maps 1:1 onto ``ServerConfig`` fields (the legacy kwargs —
    n_devices, d, dynamic_d, mem_policy, capacity_bytes, pool_size,
    beta, h2d_bw, fairness_window — kept their names and defaults)."""

    def __init__(self, policy: Policy, fns: Dict[str, FunctionSpec],
                 trace: List[TraceEvent], **kw):
        self.server = make_server(ServerConfig(**kw), fns=fns,
                                  policy=policy)
        self.trace = trace
        self.policy = policy

    def run(self) -> SimResult:
        return self.server.run_trace(self.trace)


def run_sim(policy: Policy, fns, trace, **kw) -> SimResult:
    return Simulation(policy, fns, trace, **kw).run()
