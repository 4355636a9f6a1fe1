"""Baseline queueing policies from the paper's evaluation (§6):

  FCFS   — invocations run in arrival order (OpenWhisk default).
  Batch  — dispatch the whole queue holding the oldest item (continuous-
           batching analogue, greedy locality, no fairness).
  SJF    — Paella-style shortest-expected-job-first (head-of-line risk for
           long functions).
  EEVDF  — earliest effective virtual deadline (Iluvatar's CPU policy,
           compared in §6.4).

All policies share the per-function FlowQueue substrate so the memory
manager / warm pool integration is identical — a pure queueing-policy
comparison, as in the paper.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.flow import FlowQueue, QueueState
from repro_torch.core.policy_base import Policy
from repro_torch.runtime.invocation import Invocation


class FCFS(Policy):
    name = "fcfs"

    def on_arrival(self, inv: Invocation, now: float) -> None:
        q = self.get_queue(inv.fn_id)
        q.arrive(inv, now, 0.0)
        q.state = QueueState.ACTIVE

    def choose(self, now: float) -> Optional[FlowQueue]:
        best, best_t = None, None
        for q in self.queues.values():
            h = q.head()
            if h is not None and (best_t is None or h.arrival < best_t):
                best, best_t = q, h.arrival
        return best


class Batch(Policy):
    """Greedy continuous batching: stick to one queue until drained."""
    name = "batch"

    def __init__(self):
        super().__init__()
        self._current: Optional[str] = None

    def on_arrival(self, inv: Invocation, now: float) -> None:
        q = self.get_queue(inv.fn_id)
        q.arrive(inv, now, 0.0)
        q.state = QueueState.ACTIVE

    def choose(self, now: float) -> Optional[FlowQueue]:
        if self._current is not None:
            q = self.queues.get(self._current)
            if q is not None and len(q) > 0:
                return q
            self._current = None
        best, best_t = None, None
        for q in self.queues.values():
            h = q.head()
            if h is not None and (best_t is None or h.arrival < best_t):
                best, best_t = q, h.arrival
        if best is not None:
            self._current = best.fn_id
        return best


class SJF(Policy):
    """Paella-adapted shortest-job-first on historical mean exec time."""
    name = "sjf"

    def on_arrival(self, inv: Invocation, now: float) -> None:
        q = self.get_queue(inv.fn_id)
        q.arrive(inv, now, 0.0)
        q.state = QueueState.ACTIVE

    def choose(self, now: float) -> Optional[FlowQueue]:
        cand = [q for q in self.queues.values() if len(q) > 0]
        if not cand:
            return None
        return min(cand, key=lambda q: q.tau)


class EEVDF(Policy):
    """Earliest effective virtual deadline first (Iluvatar CPU policy):
    priority = head arrival + expected service."""
    name = "eevdf"

    def on_arrival(self, inv: Invocation, now: float) -> None:
        q = self.get_queue(inv.fn_id)
        q.arrive(inv, now, 0.0)
        q.state = QueueState.ACTIVE

    def choose(self, now: float) -> Optional[FlowQueue]:
        cand = [q for q in self.queues.values() if len(q) > 0]
        if not cand:
            return None
        return min(cand, key=lambda q: q.head().arrival + q.tau)


def make_policy(name: str, **kw) -> Policy:
    from repro_torch.core.mqfq import MQFQ, SFQ, MQFQSticky
    from repro_torch.core.reference import ReferenceMQFQ, ReferenceMQFQSticky
    table = {
        "fcfs": FCFS,
        "batch": Batch,
        "sjf": SJF,
        "eevdf": EEVDF,
        "mqfq": MQFQ,
        "mqfq-sticky": MQFQSticky,
        "sfq": SFQ,
        # seed linear-scan implementations (differential testing / perf
        # baselines; reported policy name matches the indexed twin)
        "ref-mqfq": ReferenceMQFQ,
        "ref-mqfq-sticky": ReferenceMQFQSticky,
    }
    return table[name](**kw)
