"""Drive the program's wall-clock server with a generator, and record each
invocation from its due time.

Times are seconds from the window's opening on the host's monotonic
clock. The server stamps its own times (``Invocation.dispatch_time``,
``completion``) on its executor's clock, which ``offset`` maps onto the
harness's. An invocation is due when the generator means to send it; its
latency runs from then, so a generator that falls behind does not hide
the wait.
"""
from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from portbench.reference.weights import mix_seed

DRAIN_S = 60.0   # how long after the window an invocation may still finish


@dataclass
class Rec:
    idx: int
    fn: str
    due: float
    sent: float
    inv: object
    request: Dict
    t_dispatch: Optional[float] = None
    t_done: Optional[float] = None
    start_type: str = ""
    service_s: float = 0.0

    @property
    def ok(self) -> bool:
        """Answered: executed, finished, and left its tokens."""
        return (self.t_done is not None and "served" in self.request
                and "error" not in self.request
                and not getattr(self.inv, "failed", False))

    @property
    def latency(self) -> float:
        return self.t_done - self.due


@dataclass
class Drive:
    """The context a generator drives: ``now``, ``wait_until``,
    ``submit`` and ``next_completion``; ``timers`` are (time, callback)
    pairs run from the generator's thread when due (the trace slice)."""
    server: object
    seed: int
    warm_s: float
    seconds: float
    timers: List[Tuple[float, Callable]] = field(default_factory=list)
    records: List[Rec] = field(default_factory=list)

    def __post_init__(self):
        self.done: "queue.Queue" = queue.Queue()
        self.server.bus.on_complete(lambda ev: self.done.put(ev.inv))
        self.origin = time.monotonic() + self.warm_s
        # executor clock -> seconds from the window's opening
        self.offset = time.monotonic() - self.server.executor.now() \
            - self.origin
        self.timers.sort(key=lambda t: t[0])

    def now(self) -> float:
        return time.monotonic() - self.origin

    def _fire(self) -> float:
        """Run due timers; the time left to the next one."""
        while self.timers and self.timers[0][0] <= self.now():
            self.timers.pop(0)[1]()
        return self.timers[0][0] - self.now() if self.timers else 1e9

    def wait_until(self, t: float) -> None:
        while True:
            nxt = self._fire()
            left = t - self.now()
            if left <= 0:
                return
            time.sleep(min(left, nxt))

    def submit(self, fn: str, due: float) -> Rec:
        idx = len(self.records)
        request = {"seed": mix_seed(self.seed, 1 << 20, idx), "idx": idx}
        sent = self.now()
        inv = self.server.submit(fn, request)
        rec = Rec(idx, fn, due, sent, inv, request)
        self.records.append(rec)
        return rec

    def next_completion(self, until: float) -> Optional[Rec]:
        """The next invocation to complete, or None once ``until`` has
        passed."""
        while True:
            nxt = self._fire()
            left = until - self.now()
            if left <= 0:
                return None
            try:
                inv = self.done.get(timeout=min(left, nxt))
            except queue.Empty:
                continue
            return self.records[inv.request["idx"]]

    def finish(self) -> object:
        """Wait for every invocation until DRAIN_S after the window, stop
        the server and stamp each record. Returns the server's result."""
        deadline = time.monotonic() + max(self.seconds - self.now(), 0) \
            + DRAIN_S
        try:
            self.server.drain(timeout=max(deadline - time.monotonic(), 0.1))
        except TimeoutError:
            pass                   # the late ones count as failed
        while self.timers:
            self.timers.pop(0)[1]()
        res = self.server.stop()
        for r in self.records:
            inv = r.inv
            if inv.dispatch_time is not None:
                r.t_dispatch = inv.dispatch_time + self.offset
            if inv.completion is not None \
                    and inv.completion + self.offset <= self.seconds \
                    + DRAIN_S:
                r.t_done = inv.completion + self.offset
            r.start_type = inv.start_type
            r.service_s = inv.service_time or 0.0
        return res

