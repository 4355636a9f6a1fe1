"""Reference MQFQ-Sticky: the seed's linear-scan implementation.

This module preserves the original O(F)-per-decision scheduler exactly as
it shipped in the seed (full queue rescan in ``choose``, list-filter
candidates, sort-based preferential dispatch) so that the indexed
implementation in ``repro.core.mqfq`` can be differentially tested
against it: ``tests/test_scheduler_equivalence.py`` replays identical
traces through both and asserts bit-identical dispatch sequences and
RunResult metrics.

One deliberate semantic fix is applied to BOTH implementations (and
pinned here so the differential test enforces it): ``_refresh_global_vt``
takes the minimum VT over queues with *pending* work, not over all
``backlogged`` queues. The seed used ``backlogged`` (pending OR
in-flight), so a queue whose last invocation was dispatched but not yet
completed pinned Global_VT at its stale VT — every other queue sitting at
``VT >= Global_VT + T`` stayed throttled with nothing dispatchable, an
idle-device stall that violates work conservation. A queue with no
pending work cannot advance its own VT, so it must not hold the global
floor; SFQ's virtual time follows the minimum start tag of *dispatchable*
flows. ``tests/test_mqfq.py::TestThrottling::test_inflight_only_queue_does_not_stall_global_vt``
is the regression test for the stall.

Do not optimize this module: it is the executable specification.
"""
from __future__ import annotations

import random
from typing import Optional

from repro_torch.core.flow import FlowQueue, QueueState
from repro_torch.core.policy_base import Policy
from repro_torch.runtime.invocation import Invocation


class ReferenceMQFQSticky(Policy):
    name = "mqfq-sticky"
    anticipatory = True

    def __init__(self, T: float = 10.0, alpha: float = 2.0,
                 sticky: bool = True, vt_by_service: bool = True,
                 deficit_vt: bool = False, seed: int = 0):
        super().__init__()
        self.T = T
        self.alpha = alpha
        self.sticky = sticky
        self.vt_by_service = vt_by_service  # False -> Fig 8a "1.0" ablation
        self.deficit_vt = deficit_vt        # beyond-paper VT settle
        self.global_vt = 0.0
        self._rng = random.Random(seed)
        self.state_listeners = []

    # -- helpers ------------------------------------------------------------
    def _refresh_global_vt(self) -> None:
        # min over queues with pending (dispatchable) work; see module
        # docstring for why in-flight-only queues are excluded.
        vts = [q.vt for q in self.queues.values() if q.pending]
        if vts:
            self.global_vt = max(self.global_vt, min(vts))

    def _throttled(self, q: FlowQueue) -> bool:
        """Complement of Eq. 1's eligibility VT < Global_VT + T, except the
        queue at the Global_VT floor is always eligible (work conservation,
        T=0 == classic SFQ)."""
        return q.vt >= self.global_vt + self.T and q.vt > self.global_vt

    def _update_state(self, q: FlowQueue, now: float) -> None:
        old = q.state
        if not q.pending and q.in_flight == 0:
            if q.state is not QueueState.INACTIVE \
                    and now - q.last_exec >= q.ttl(self.alpha):
                q.state = QueueState.INACTIVE   # queue expired
            elif q.state is QueueState.INACTIVE:
                pass
            elif self._throttled(q):
                q.state = QueueState.THROTTLED
            else:
                q.state = QueueState.ACTIVE
        elif self._throttled(q):
            q.state = QueueState.THROTTLED
        else:
            q.state = QueueState.ACTIVE
        if old is not q.state:
            for cb in self.state_listeners:
                cb(q, old, q.state, now)

    # -- Policy interface -----------------------------------------------------
    def on_arrival(self, inv: Invocation, now: float) -> None:
        q = self.get_queue(inv.fn_id)
        q.arrive(inv, now, self.global_vt)
        self._update_state(q, now)

    def choose(self, now: float) -> Optional[FlowQueue]:
        """Algorithm 1 DISPATCH (without the D-token, which the engine
        holds): returns the chosen queue or None. Linear rescan of every
        flow queue — O(F) per decision, by design (see module docstring)."""
        self.decisions += 1
        self._refresh_global_vt()
        for q in self.queues.values():
            self._update_state(q, now)
        cand = [q for q in self.queues.values()
                if q.state is QueueState.ACTIVE and len(q) > 0
                and not self._throttled(q)]
        if not cand:
            return None
        if self.sticky:
            cand.sort(key=lambda q: -len(q))           # longest queue first
            if self.device_parallelism != 1:
                cand.sort(key=lambda q: q.in_flight)   # stable: fewest in-flight
            return cand[0]
        # plain MQFQ: an arbitrary queue meeting the criteria
        return self._rng.choice(cand)

    def on_dispatch(self, q: FlowQueue, inv: Invocation, now: float) -> None:
        if self.vt_by_service:
            q.on_dispatch(inv, now)
        else:  # ablation: ignore heterogeneity, unit VT increment
            tau, q.tau = q.tau, 1.0
            q.on_dispatch(inv, now)
            q.tau = tau
        self._refresh_global_vt()
        self._update_state(q, now)

    def on_complete(self, q: FlowQueue, inv: Invocation, now: float) -> None:
        q.on_complete(inv, now, inv.service_time)
        self._update_state(q, now)

    # -- executor integration --------------------------------------------------
    def next_expiry(self, now: float,
                    bound: Optional[float] = None) -> Optional[float]:
        """Earliest future time an idle queue's anticipatory TTL lapses
        (linear scan, like everything here; ``bound`` is the indexed
        implementation's O(1) early-out hint and is ignored). The
        SimExecutor schedules a timer event at this time so
        Active->Inactive transitions (and the memory swap-outs they
        trigger) happen when the TTL actually expires rather than at the
        next arrival/completion."""
        best: Optional[float] = None
        for q in self.queues.values():
            if q.pending or q.in_flight or q.state is QueueState.INACTIVE:
                continue
            due = q.last_exec + q.ttl(self.alpha)
            if due > now and (best is None or due < best):
                best = due
        return best


class ReferenceMQFQ(ReferenceMQFQSticky):
    """Original MQFQ: arbitrary candidate choice (no sticky heuristic)."""
    name = "mqfq"

    def __init__(self, T: float = 10.0, alpha: float = 2.0, seed: int = 0):
        super().__init__(T=T, alpha=alpha, sticky=False, seed=seed)
