"""Deprecation shim over ``repro_torch.server`` (the unified control plane).

The wall-clock serving engine now lives in ``repro.server``:
``WallClockExecutor`` drives the same ``ControlPlane`` as the simulator
— gaining multi-device placement, warm-pool container accounting,
memory admission control and fairness tracking the old ad-hoc engine
lacked. ``ServingEngine`` remains for existing call sites; new code
should use::

    from repro_torch.server import ServerConfig, make_server
    srv = make_server(ServerConfig(executor="wallclock", d=2),
                      endpoints=endpoints)
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.policy_base import Policy
from repro_torch.runtime.device import TorchEndpoint
from repro_torch.runtime.invocation import Invocation
from repro_torch.server.config import ServerConfig, make_server


class ServingEngine:
    def __init__(self, endpoints: Dict[str, TorchEndpoint], policy: Policy,
                 d: int = 2, capacity_bytes: Optional[int] = None,
                 max_resident: Optional[int] = None):
        if capacity_bytes is None:
            # legacy knob: "keep at most max_resident endpoints uploaded"
            # -> a byte budget for the unified memory manager
            max_resident = max_resident or max(2, len(endpoints) // 2)
            per_ep = max((int(ep.weight_bytes) for ep in endpoints.values()),
                         default=1)
            capacity_bytes = max(per_ep * max_resident, 1)
        cfg = ServerConfig(executor="wallclock", d=d,
                           capacity_bytes=capacity_bytes)
        self.server = make_server(cfg, endpoints=endpoints, policy=policy)
        self.endpoints = endpoints
        self.policy = policy

    # -- legacy API, forwarded to the unified server -------------------------
    def now(self) -> float:
        return self.server.executor.now()

    def submit(self, fn_id: str, request: Optional[dict] = None
               ) -> Invocation:
        return self.server.submit(fn_id, request)

    def start(self) -> None:
        self.server.start()

    def drain(self, timeout: float = 300.0) -> None:
        self.server.drain(timeout)

    def stop(self):
        return self.server.stop()

    @property
    def completed(self) -> List[Invocation]:
        return self.server.completed
