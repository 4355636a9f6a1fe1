"""Invocation records with full latency breakdown.

``slots=True``: the simulator creates one record per trace event, so on
full-metrics million-invocation replays the per-instance ``__dict__``
dominated RSS. Slots cut ~45% per record and make attribute access on
the event-loop hot path cheaper. Everything the lifecycle ever sets is a
declared field — including ``charged_tau`` (the VT charge pinned at
dispatch for the deficit settle) and ``request`` (the wall-clock
executor's payload), which used to be monkey-patched on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(slots=True)
class Invocation:
    fn_id: str
    arrival: float
    inv_id: int = 0
    # filled over the lifecycle
    dispatch_time: Optional[float] = None
    exec_start: Optional[float] = None   # after cold-start / upload overhead
    completion: Optional[float] = None
    start_type: str = ""                 # warm | host_warm | cold
    overhead: float = 0.0                # cold start + memory wait
    service_time: float = 0.0            # device execution time
    device_id: int = 0
    charged_tau: Optional[float] = None  # tau charged to VT at dispatch
    request: Optional[dict] = None       # wall-clock request payload
    # fault plane (ISSUE 9): attempt retries consumed, and the final
    # disposition flags — ``shed`` (rejected at arrival by degraded-mode
    # load shedding, never queued) and ``failed`` (an injected fault the
    # platform did not recover from: retry budget exhausted under
    # recovery, or an error that "completed" under recovery-off).
    retries: int = 0
    shed: bool = False
    failed: bool = False
    # open-loop feeder slip: how late the replay feeder released this
    # arrival relative to its trace timestamp (>= 0 — feeders never
    # release early). Separate from queueing delay: ``arrival`` is
    # stamped at actual release, so latency/queue_time start *after*
    # the slip and feeder saturation can't masquerade as queueing.
    lateness: Optional[float] = None

    @property
    def latency(self) -> float:
        assert self.completion is not None
        return self.completion - self.arrival

    @property
    def queue_time(self) -> float:
        assert self.dispatch_time is not None
        return self.dispatch_time - self.arrival

    @property
    def done(self) -> bool:
        return self.completion is not None
