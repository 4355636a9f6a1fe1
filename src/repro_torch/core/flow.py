"""Per-function flow queues: the unit MQFQ-Sticky schedules (paper §4.1).

Each serverless function (here: model endpoint) owns one FlowQueue holding
pending invocations. The queue tracks virtual time (VT), the anticipatory
state machine (Active / Throttled / Inactive), the historical service-time
average tau_k, and the inter-arrival-time estimate used for the
anticipatory TTL = alpha * IAT.
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional

from repro_torch.runtime.invocation import Invocation


class QueueState(enum.Enum):
    ACTIVE = "active"
    THROTTLED = "throttled"
    INACTIVE = "inactive"


@dataclass(slots=True, eq=False)   # identity semantics: queues are
class FlowQueue:                   # stateful singletons per fn_id, and the
    fn_id: str                     # scheduler index embeds them in heap
    weight: float = 1.0            # entries (identity ==/hash keeps tuple
                                   # tie-compares O(1) and queues set-able)
    # creation index (dict order): SchedulerIndex uses it to reproduce the
    # reference scheduler's stable-sort / dict-iteration tie-breaking
    ins: int = 0
    # virtual time: total service accrued by this queue (paper Table 2)
    vt: float = 0.0
    state: QueueState = QueueState.INACTIVE
    pending: Deque[Invocation] = field(default_factory=deque)
    in_flight: int = 0

    # moving estimates
    tau: float = 0.1          # historical avg execution time tau_k
    _tau_n: int = 0
    iat: float = 10.0         # inter-arrival-time estimate
    last_arrival: Optional[float] = None
    last_exec: float = 0.0    # last dispatch-or-completion time (TTL anchor)

    # accounting
    total_service: float = 0.0
    dispatched: int = 0
    # beyond-paper: settle the VT debt with the *measured* service time on
    # completion (the paper charges only the a-priori tau_k at dispatch,
    # so mispredicted functions drift from their true service share)
    deficit_vt: bool = False

    EMA = 0.3

    def __len__(self) -> int:
        return len(self.pending)

    @property
    def backlogged(self) -> bool:
        return bool(self.pending) or self.in_flight > 0

    # -- lifecycle ----------------------------------------------------------
    def arrive(self, inv: Invocation, now: float, global_vt: float) -> None:
        if self.last_arrival is not None:
            gap = max(now - self.last_arrival, 1e-9)
            self.iat = (1 - self.EMA) * self.iat + self.EMA * gap \
                if self._tau_n else gap
        self.last_arrival = now
        if not self.backlogged:
            # SFQ start-tag lifting: an idle queue must not bank credit.
            self.vt = max(self.vt, global_vt)
        self.pending.append(inv)

    def on_dispatch(self, inv: Invocation, now: float) -> None:
        # VT advances by the *expected* service (tau_k / weight); shorter
        # functions therefore get more invocations per unit VT (paper §4.2).
        self.vt += self.tau / self.weight
        inv.charged_tau = self.tau
        self.in_flight += 1
        self.dispatched += 1
        self.last_exec = now

    def on_complete(self, inv: Invocation, now: float,
                    service_time: float) -> None:
        self.in_flight -= 1
        self.last_exec = now
        self.total_service += service_time
        if self.deficit_vt:
            charged = inv.charged_tau
            if charged is None:         # never dispatched through a queue
                charged = service_time
            self.vt += (service_time - charged) / self.weight
        self._tau_n += 1
        if self._tau_n == 1:
            self.tau = service_time
        else:
            self.tau = (1 - self.EMA) * self.tau + self.EMA * service_time

    def ttl(self, alpha: float) -> float:
        return alpha * self.iat

    def pop(self) -> Invocation:
        return self.pending.popleft()

    def head(self) -> Optional[Invocation]:
        return self.pending[0] if self.pending else None
