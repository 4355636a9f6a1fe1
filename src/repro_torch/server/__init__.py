"""Unified serving control plane (paper Fig. 2, §4-§5).

The port's copy of ``repro.server``: one clock-agnostic ``ControlPlane``
owns the full dispatch pipeline — MQFQ policy choose -> sticky device
placement -> memory admission -> D-token + warm-pool + residency
acquisition -> start-type classification — and is driven by two
interchangeable executors:

  ``SimExecutor``        virtual clock, discrete-event heap (the paper's
                         experiments, deterministic on the host)
  ``WallClockExecutor``  dispatcher thread + worker pool over real
                         ``TorchEndpoint`` execution

Entry point::

    from repro_torch.server import ServerConfig, make_server

    cfg = ServerConfig(policy="mqfq-sticky",
                       policy_kwargs={"T": 10.0}, d=2)
    res = make_server(cfg, fns=fns).run_trace(trace)     # simulation

    cfg = ServerConfig(executor="wallclock", d=2)
    srv = make_server(cfg, endpoints=endpoints)          # real torch
    srv.start(); srv.submit("qwen3-1.7b", {"seed": 0})
    srv.drain(); res = srv.stop()

Both paths return the same ``RunResult``.
``repro_torch.runtime.simulate.run_sim`` and
``repro_torch.runtime.engine.ServingEngine`` remain as thin deprecation
shims over this package.
"""
from repro_torch.server.config import ServerConfig, make_server, specs_from_endpoints
from repro_torch.server.control import ControlPlane, DeviceState, DispatchDecision
from repro_torch.server.events import (CompleteEvent, DispatchEvent, EventBus,
                                 StateChangeEvent)
from repro_torch.server.executors import (Server, ShardedWallClockExecutor,
                                    SimExecutor, WallClockExecutor)
from repro_torch.server.metrics import (MergedFairness, MergedPools, RunResult,
                                  StreamingStats, nearest_rank, quantile)
from repro_torch.server.shard import (ArrayVTBus, LocalVTBus, ShardedControlPlane,
                                ShardRouter, hash_shard)
from repro_torch.server.stub import StubEndpoint

__all__ = [
    "ServerConfig", "make_server", "specs_from_endpoints",
    "ControlPlane", "DeviceState", "DispatchDecision",
    "EventBus", "StateChangeEvent", "DispatchEvent", "CompleteEvent",
    "Server", "SimExecutor", "WallClockExecutor",
    "ShardedControlPlane", "ShardedWallClockExecutor", "ShardRouter",
    "LocalVTBus", "ArrayVTBus", "hash_shard",
    "MergedFairness", "MergedPools",
    "RunResult", "StreamingStats", "StubEndpoint",
    "nearest_rank", "quantile",
]
