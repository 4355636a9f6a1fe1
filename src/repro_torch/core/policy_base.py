"""Queueing-policy interface shared by MQFQ-Sticky and the baselines.

The engine drives: on_arrival -> choose()/on_dispatch -> on_complete.
``device_parallelism`` mirrors the engine's current dynamic D so policies
(like MQFQ-Sticky's tie-break) can condition on it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.flow import FlowQueue, QueueState
from repro_torch.runtime.invocation import Invocation


class Policy:
    name = "base"
    # MQFQ-family marker: the policy runs the anticipatory queue state
    # machine and expects queue-state-driven memory management (the
    # control plane keys on this, not on concrete classes, so the
    # reference and indexed implementations are treated identically).
    anticipatory = False

    def __init__(self):
        self.queues: Dict[str, FlowQueue] = {}
        self.device_parallelism = 1
        self.state_listeners: List = []
        self.deficit_vt = False   # beyond-paper: measured-service VT settle
        self.decisions = 0        # choose() calls (scale benchmark metric)

    def get_queue(self, fn_id: str) -> FlowQueue:
        q = self.queues.get(fn_id)
        if q is None:
            q = FlowQueue(fn_id=fn_id, ins=len(self.queues),
                          deficit_vt=self.deficit_vt)
            self.queues[fn_id] = q
        return q

    # -- to implement -----------------------------------------------------
    def on_arrival(self, inv: Invocation, now: float) -> None:
        raise NotImplementedError

    def choose(self, now: float) -> Optional[FlowQueue]:
        raise NotImplementedError

    def on_dispatch(self, q: FlowQueue, inv: Invocation, now: float) -> None:
        q.on_dispatch(inv, now)

    def on_complete(self, q: FlowQueue, inv: Invocation, now: float) -> None:
        q.on_complete(inv, now, inv.service_time)

    # -- fault recovery ------------------------------------------------------
    # A failed attempt must leave the flow charged exactly once per
    # *completing* attempt: ``on_failure`` reverts the dispatch-time VT
    # charge (no tau EMA sample, no fairness service credit — the
    # attempt did no useful work), and ``on_requeue`` re-activates the
    # queue after the control plane re-inserts the invocation at the
    # FRONT of ``q.pending`` (seniority preserved; arrival stats such as
    # the IAT EMA are not re-sampled).

    def on_failure(self, q: FlowQueue, inv: Invocation, now: float) -> None:
        q.in_flight -= 1
        q.last_exec = now
        if inv.charged_tau is not None:
            q.vt -= inv.charged_tau / q.weight
            inv.charged_tau = None

    def on_requeue(self, q: FlowQueue, now: float) -> None:
        q.state = QueueState.ACTIVE

    def next_expiry(self, now: float,
                    bound: Optional[float] = None) -> Optional[float]:
        """Earliest strictly-future time at which this policy's internal
        state changes without an arrival/completion (e.g. an anticipatory
        TTL lapse). Executors arm a timer event at this time; None means
        no timed transition is pending. ``bound`` is the executor's
        earliest already-armed timer — implementations may return None
        immediately when nothing earlier than it can be due. Baselines
        have none."""
        return None

    # -- cross-shard virtual-time sync ---------------------------------------
    # The sharded control plane periodically collects every shard's
    # ``min_pending_vt`` and re-injects the max of those minima as a
    # Global_VT floor (MQFQ's loosely-synchronized global clock across
    # per-CPU dispatchers). Policies without a virtual clock (FCFS, SJF)
    # neither publish nor accept a floor, so the sync degenerates to a
    # no-op for them.

    def min_pending_vt(self) -> Optional[float]:
        """Min start tag over this policy's queues with pending work —
        the shard's contribution to the cross-shard Global_VT snapshot.
        None when nothing is pending (or the policy has no VT)."""
        return None

    def raise_vt_floor(self, floor: float) -> None:
        """Inject an external Global_VT floor (monotone raise). No-op for
        policies without a virtual clock."""

    # -- shared accounting ---------------------------------------------------
    @property
    def total_pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def backlogged_queues(self) -> List[FlowQueue]:
        return [q for q in self.queues.values() if q.backlogged]
