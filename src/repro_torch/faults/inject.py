"""Runtime fault disposition + shared counters + wallclock wrapper.

One ``FaultInjector`` per server (shards of a sharded plane share it),
holding the plan, the per-fn execution-attempt counters that trigger
endpoint faults, and every fault/recovery counter surfaced in
``RunResult.faults``. The simulator consults it at realize time; the
wall-clock path consults it from inside ``FaultyEndpoint.execute`` —
both increment the same per-fn counter, so a seeded plan injects on the
same logical attempt under either clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.faults.plan import EndpointFault, FaultPlan

INF = float("inf")


class FaultError(RuntimeError):
    """Raised by an injected endpoint fault. ``mode`` is "error"
    (immediate raise) or "hang" (attempt stalled, then killed)."""

    def __init__(self, fn_id: str, mode: str = "error"):
        super().__init__(f"injected {mode} fault on {fn_id}")
        self.fn_id = fn_id
        self.mode = mode


@dataclass
class FaultStats:
    """Immutable snapshot of an injector's counters for ``RunResult``."""
    arrivals: int = 0
    completed_ok: int = 0
    completed_failed: int = 0    # recovery-off: errors that "completed"
    shed: int = 0
    dropped: int = 0             # retry budget/deadline exhausted
    attempts_failed: int = 0
    retries: int = 0
    requeued: int = 0
    device_faults: int = 0
    endpoint_faults: int = 0
    transfer_aborts: int = 0
    feeder_kills: int = 0
    quarantined: int = 0
    readmitted: int = 0

    @property
    def accounted(self) -> int:
        """Arrivals with a final disposition — conservation requires
        this to equal ``arrivals`` at drain."""
        return (self.completed_ok + self.completed_failed
                + self.shed + self.dropped)


class FaultInjector:
    """Plan + per-fn attempt counters + fault/recovery counters."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._exec_n: Dict[str, int] = {}
        self._by_fn: Dict[str, Dict[int, EndpointFault]] = {}
        for f in plan.endpoint_faults:
            self._by_fn.setdefault(f.fn_id, {})[f.nth] = f
        # counters (mirrors FaultStats; mutated under the owning
        # executor's lock on the wallclock path)
        self.arrivals = 0
        self.completed_ok = 0
        self.completed_failed = 0
        self.shed = 0
        self.dropped = 0
        self.attempts_failed = 0
        self.retries = 0
        self.requeued = 0
        self.device_faults = 0
        self.endpoint_faults = 0
        self.transfer_aborts = 0
        self.feeder_kills = 0
        self.quarantined = 0
        self.readmitted = 0

    # -- disposition -------------------------------------------------------
    def next_endpoint_fault(self, fn_id: str) -> Optional[EndpointFault]:
        """Advance fn's execution-attempt counter; return the fault
        scheduled for this attempt, if any."""
        n = self._exec_n.get(fn_id, 0)
        self._exec_n[fn_id] = n + 1
        faults = self._by_fn.get(fn_id)
        if faults is None:
            return None
        f = faults.get(n)
        if f is not None:
            self.endpoint_faults += 1
        return f

    def device_down(self, dev_id: int, now: float) -> bool:
        """Is the device inside any fault window at ``now``?"""
        for f in self.plan.device_faults:
            if f.dev_id == dev_id and f.t <= now < f.t + f.duration:
                return True
        return False

    def device_fault_end(self, dev_id: int, now: float) -> float:
        """End of the fault window covering ``now`` (``now`` itself when
        clear; ``inf`` for a permanent fault)."""
        end = now
        for f in self.plan.device_faults:
            if f.dev_id == dev_id and f.t <= now < f.t + f.duration:
                end = max(end, f.t + f.duration)
        return end

    def snapshot(self) -> FaultStats:
        return FaultStats(
            arrivals=self.arrivals, completed_ok=self.completed_ok,
            completed_failed=self.completed_failed, shed=self.shed,
            dropped=self.dropped, attempts_failed=self.attempts_failed,
            retries=self.retries, requeued=self.requeued,
            device_faults=self.device_faults,
            endpoint_faults=self.endpoint_faults,
            transfer_aborts=self.transfer_aborts,
            feeder_kills=self.feeder_kills,
            quarantined=self.quarantined, readmitted=self.readmitted)


class FaultyEndpoint:
    """Endpoint wrapper for the wall-clock executors.

    Delegates the full endpoint protocol (lock, compile/upload/evict,
    residency flags) to the wrapped endpoint; ``execute`` first consults
    the shared injector's per-fn attempt counter and raises
    ``FaultError`` on a scheduled attempt — sleeping ``latency`` first
    for hang faults, which models the invoke watchdog killing a stuck
    container after that long."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._injector = injector
        self.fn_id = inner.fn_id
        self.spec = inner.spec
        self.lock = inner.lock

    # -- protocol delegation ----------------------------------------------
    @property
    def compiled(self) -> bool:
        return self._inner.compiled

    @property
    def resident(self) -> bool:
        return self._inner.resident

    @property
    def weight_bytes(self) -> int:
        return self._inner.weight_bytes

    @property
    def last_use(self):
        return self._inner.last_use

    @last_use.setter
    def last_use(self, v) -> None:
        self._inner.last_use = v

    def compile(self) -> None:
        self._inner.compile()

    def upload(self) -> None:
        self._inner.upload()

    def evict(self) -> None:
        self._inner.evict()

    def execute(self, request=None):
        f = self._injector.next_endpoint_fault(self.fn_id)
        if f is not None:
            if f.mode == "hang" and f.latency > 0.0:
                time.sleep(f.latency)
            raise FaultError(self.fn_id, f.mode)
        return self._inner.execute(request)
