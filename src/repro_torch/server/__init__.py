"""Unified serving control plane (paper Fig. 2, §4-§5), wall-clock side.

The port's copy of ``repro.server``: one clock-agnostic ``ControlPlane``
owns the full dispatch pipeline — MQFQ policy choose -> sticky device
placement -> memory admission -> D-token + warm-pool + residency
acquisition -> start-type classification — driven by the
``WallClockExecutor`` (dispatcher thread + worker pool over real
``TorchEndpoint`` execution).

Entry point::

    from repro_torch.server import ServerConfig, make_server

    cfg = ServerConfig(executor="wallclock", d=2)
    srv = make_server(cfg, endpoints=endpoints)          # real torch
    srv.start(); srv.submit("qwen3-1.7b", {"seed": 0})
    srv.drain(); res = srv.stop()
"""
from repro_torch.server.config import ServerConfig, make_server, specs_from_endpoints
from repro_torch.server.control import ControlPlane, DeviceState, DispatchDecision
from repro_torch.server.events import (CompleteEvent, DispatchEvent, EventBus,
                                       StateChangeEvent)
from repro_torch.server.executors import Server, WallClockExecutor
from repro_torch.server.metrics import (MergedFairness, MergedPools, RunResult,
                                        StreamingStats, nearest_rank, quantile)
from repro_torch.server.stub import StubEndpoint

__all__ = [
    "ServerConfig", "make_server", "specs_from_endpoints",
    "ControlPlane", "DeviceState", "DispatchDecision",
    "EventBus", "StateChangeEvent", "DispatchEvent", "CompleteEvent",
    "Server", "WallClockExecutor",
    "MergedFairness", "MergedPools",
    "RunResult", "StreamingStats", "StubEndpoint",
    "nearest_rank", "quantile",
]
