"""Typed event bus for the serving control plane.

Replaces the ad-hoc ``policy.state_listeners`` callback list the old
engines used: subscribers get frozen event records instead of positional
args, and dispatch/completion become first-class events (the old list
only carried queue-state changes).

Subscribers must be fast and must not call back into the control plane;
they run synchronously on the dispatch path (executors offload real work
— e.g. weight uploads — to their own pools).

No-subscriber fast path: the control plane caches references to the
subscriber lists below and constructs an event record *only when the
matching list is non-empty* (or when ``ServerConfig.sampling ==
"per_event"``, the pre-PR reference mode, which always constructs).
Simulation runs subscribe to nothing, so the hot loop skips both the
dataclass allocation and the emit call entirely. Two consequences:

  - subscribing mid-run works (``on_*`` appends to the same cached list
    object), and is exactly how the differential tests flip the slow
    path on;
  - the lists themselves must never be rebound — append/clear only.

The record classes use ``slots=True``: they are allocated per dispatch /
completion when anyone subscribes, so they should stay cheap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

from repro_torch.core.flow import QueueState
from repro_torch.runtime.invocation import Invocation


@dataclass(frozen=True, slots=True)
class StateChangeEvent:
    """A flow queue moved between Active / Throttled / Inactive."""
    fn_id: str
    old: QueueState
    new: QueueState
    time: float


@dataclass(frozen=True, slots=True)
class DispatchEvent:
    """An invocation cleared the full pipeline and left the queue."""
    inv: Invocation
    fn_id: str
    device_id: int
    start_type: str            # warm | host_warm | cold
    time: float


@dataclass(frozen=True, slots=True)
class CompleteEvent:
    inv: Invocation
    fn_id: str
    device_id: int
    time: float


class EventBus:
    def __init__(self):
        self._state_change: List[Callable[[StateChangeEvent], None]] = []
        self._dispatch: List[Callable[[DispatchEvent], None]] = []
        self._complete: List[Callable[[CompleteEvent], None]] = []

    # -- subscribe (return the callback so these work as decorators) --------
    def on_state_change(self, cb: Callable[[StateChangeEvent], None]):
        self._state_change.append(cb)
        return cb

    def on_dispatch(self, cb: Callable[[DispatchEvent], None]):
        self._dispatch.append(cb)
        return cb

    def on_complete(self, cb: Callable[[CompleteEvent], None]):
        self._complete.append(cb)
        return cb

    # -- emit ---------------------------------------------------------------
    def emit_state_change(self, ev: StateChangeEvent) -> None:
        for cb in self._state_change:
            cb(ev)

    def emit_dispatch(self, ev: DispatchEvent) -> None:
        for cb in self._dispatch:
            cb(ev)

    def emit_complete(self, ev: CompleteEvent) -> None:
        for cb in self._complete:
            cb(ev)
