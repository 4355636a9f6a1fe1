"""MQFQ-Sticky (paper Algorithm 1) and plain MQFQ — indexed hot path.

Differences from classic SFQ/MQFQ, per the paper:
  - queues may dispatch while VT <= Global_VT + T (queue over-run ->
    batching; non-strict so T=0 degrades to classic SFQ, not starvation)
  - empty queues stay Active for TTL = alpha * IAT (anticipatory scheduling)
  - preferential dispatch: longest queue first; with D > 1, tie-break on
    fewest in-flight ("sticky" locality + anti-self-collision)

Note on the paper's Alg. 1 line 22 / §4.2 text: both state the throttle
comparison with the inequality reversed ("queue.VT + T >= Global_VT");
the consistent reading (used by the fairness proof, Eq. 1) is the strict
*eligible iff VT < Global_VT + T*. To keep T=0 work-conserving (classic
SFQ, not starvation) the queue sitting at the Global_VT floor is always
eligible: eligible iff (VT < G+T) or (VT <= G); throttled otherwise.

This is the O(log F)-per-decision implementation over ``SchedulerIndex``
(see ``repro.core.index``). The seed's O(F) linear-scan scheduler is kept
verbatim in ``repro.core.reference`` as the executable specification;
``tests/test_scheduler_equivalence.py`` proves this implementation
produces bit-identical dispatch sequences and metrics. Two rules keep the
equivalence exact:

  - Transitions deferred by the reference to its next full rescan (TTL
    expiries, un-throttles after a Global_VT advance) fire here at the
    same call site — the top of ``choose`` — and in the same order: queue
    creation order, which the index entries' ``ins`` tie-break preserves.
  - Global_VT is the minimum VT over queues with *pending* work (not all
    backlogged queues) in both implementations; see
    ``repro.core.reference`` for why the seed's backlogged-based floor
    stalled dispatch when a flow's work was entirely in flight.
"""
from __future__ import annotations

import heapq
import random
from typing import List, Optional

from repro_torch.core.flow import FlowQueue, QueueState
from repro_torch.core.index import SchedulerIndex
from repro_torch.core.policy_base import Policy
from repro_torch.runtime.invocation import Invocation

# hoisted enum members: _update_state runs ~1.5x per event and the
# repeated QueueState.<X> attribute loads were measurable there
_ACTIVE = QueueState.ACTIVE
_THROTTLED = QueueState.THROTTLED
_INACTIVE = QueueState.INACTIVE


def throttled(vt: float, global_vt: float, T: float) -> bool:
    """The scalar plane's throttle test, as a pure function of the three
    scalars it depends on: complement of Eq. 1's eligibility
    ``VT < Global_VT + T``, except the queue at the Global_VT floor is
    always eligible (work conservation, so T=0 degrades to classic SFQ).
    This is THE throttle arithmetic — ``MQFQSticky`` routes through it
    (modulo the inlined copy in ``_update_state``) and the vectorized
    batch plane (``repro.batchsim.step``) mirrors it element-wise; the
    differential suite cross-checks both against this function."""
    return vt >= global_vt + T and vt > global_vt


def ttl_expired(now: float, last_exec: float, alpha: float,
                iat: float) -> bool:
    """Anticipatory TTL lapse test for an *idle* queue (no pending work,
    nothing in flight): the queue falls to Inactive once ``alpha * IAT``
    has passed since its last dispatch-or-completion. Pure mirror point
    for ``repro.batchsim`` — same caveat as ``throttled``."""
    return now - last_exec >= alpha * iat


class MQFQSticky(Policy):
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
        self.index = SchedulerIndex(self.queues)
        # False restores the pre-guard deferred-transition scan on every
        # choose() — set by the control plane under sampling="per_event"
        # so that reference mode reproduces the pre-PR cost profile
        self.defer_guard = True

    # -- helpers ------------------------------------------------------------
    def _refresh_global_vt(self) -> None:
        """Global_VT floor: min VT over queues with *pending* work, read
        off the gvt heap under validate-and-discard. The walk lives here
        rather than in SchedulerIndex because it runs on every choose()
        and every dispatch and the valid-top case is the overwhelming
        majority — one frame instead of two."""
        h = self.index._gvt
        while h:
            vt, _, q = h[0]
            if q.pending and q.vt == vt:
                if vt > self.global_vt:
                    self.global_vt = vt
                return
            heapq.heappop(h)

    def _throttled(self, q: FlowQueue) -> bool:
        """See module-level ``throttled`` (the shared arithmetic)."""
        return throttled(q.vt, self.global_vt, self.T)

    def _update_state(self, q: FlowQueue, now: float) -> None:
        """Same state machine as the reference, plus index maintenance.
        Every mutation of a queue's key fields (len, in_flight, vt, state,
        last_exec) flows through here, so the index re-learns the queue's
        current keys exactly when they can have changed. The throttle
        test (``_throttled``) and TTL are inlined — this runs ~1.5x per
        event and was the single largest scheduler-core frame."""
        old = q.state
        pending = q.pending
        idle = not pending and q.in_flight == 0
        vt = q.vt
        g = self.global_vt
        throttled = vt >= g + self.T and vt > g   # see _throttled
        if idle:
            if old is not _INACTIVE \
                    and now - q.last_exec >= self.alpha * q.iat:
                new = _INACTIVE                   # queue expired
            elif old is _INACTIVE:
                new = _INACTIVE
            elif throttled:
                new = _THROTTLED
            else:
                new = _ACTIVE
        elif throttled:
            new = _THROTTLED
        else:
            new = _ACTIVE
        q.state = new
        idx = self.index
        if new is _ACTIVE and pending:
            idx.note_candidate(q)
        else:
            idx.cand.discard(q)         # drop_candidate, inlined
        if new is _THROTTLED:
            idx.note_throttled(q)
        if idle and new is not _INACTIVE:
            idx.note_idle(q, self.alpha)
        if old is not new:
            for cb in self.state_listeners:
                cb(q, old, new, now)

    def _apply_deferred(self, now: float) -> None:
        """Fire the transitions the reference discovers during its full
        rescan: TTL expiries and throttle releases, in creation order.
        Callers gate this behind the O(1) heap-top guard inlined in
        ``choose``; the body always runs the full pass."""
        idx = self.index
        due: List[FlowQueue] = list(idx.pop_due_expiries(now, self.alpha))
        due += idx.pop_unthrottled(self.global_vt, self.T)
        if not due:
            return
        seen = set()
        due = [q for q in due
               if q.fn_id not in seen and not seen.add(q.fn_id)]
        due.sort(key=lambda q: q.ins)
        for q in due:
            self._update_state(q, now)

    # -- Policy interface -----------------------------------------------------
    def on_arrival(self, inv: Invocation, now: float) -> None:
        q = self.get_queue(inv.fn_id)
        q.arrive(inv, now, self.global_vt)
        self.index.note_pending_vt(q)
        self._update_state(q, now)

    def choose(self, now: float) -> Optional[FlowQueue]:
        """Algorithm 1 DISPATCH (without the D-token, which the engine
        holds): returns the chosen queue or None. O(log F) amortized on
        the sticky path; the plain-MQFQ random path sorts the candidate
        set (O(C log C)) because reproducing the reference's
        ``rng.choice`` needs the full list in creation order.

        The deferred-transition guard is inlined (choose() runs ~1.5x
        per event and the no-deferred-work case is the hot path): raw
        expiry/throttle heap tops are *lower bounds* on the live values
        — an idle queue's freshest expiry entry equals its frozen true
        due, every throttled queue keeps a current (vt, ins) entry, and
        stale entries only under-shoot — so a negative answer is exact
        and a stale top merely triggers a spurious full pass. VT
        eligibility is monotone downward, so an ineligible throttle top
        implies every deeper entry is ineligible too.
        ``defer_guard=False`` (per_event reference mode) restores the
        pre-PR unconditional full scan."""
        self.decisions += 1
        self._refresh_global_vt()
        idx = self.index
        if not self.defer_guard:
            self._apply_deferred(now)
        else:
            h = idx._expiry
            if h and h[0][0] <= now:
                self._apply_deferred(now)
            else:
                t = idx._throttle
                if t:
                    vt = t[0][0]
                    g = self.global_vt
                    if vt < g + self.T or vt <= g:   # _eligible, inlined
                        self._apply_deferred(now)
        if not idx.cand:
            return None
        if self.sticky:
            return idx.best_candidate(self.device_parallelism)
        # plain MQFQ: an arbitrary queue meeting the criteria
        return self._rng.choice(idx.candidates_in_creation_order())

    def on_dispatch(self, q: FlowQueue, inv: Invocation, now: float) -> None:
        if self.vt_by_service:
            q.on_dispatch(inv, now)
        else:  # ablation: ignore heterogeneity, unit VT increment
            tau, q.tau = q.tau, 1.0
            q.on_dispatch(inv, now)
            q.tau = tau
        self.index.note_pending_vt(q)   # VT advanced (and len changed)
        self._refresh_global_vt()
        self._update_state(q, now)

    def on_complete(self, q: FlowQueue, inv: Invocation, now: float) -> None:
        q.on_complete(inv, now, inv.service_time)
        self.index.note_pending_vt(q)   # deficit settle may move VT
        self._update_state(q, now)

    # -- fault recovery --------------------------------------------------------
    def on_failure(self, q: FlowQueue, inv: Invocation, now: float) -> None:
        """Revert the dispatch-time VT charge (base) and re-learn the
        queue's keys. The reverted VT may fall below the Global_VT
        floor — deliberate: the wronged flow regains its seniority and
        is immediately eligible; the monotone floor itself never drops."""
        super().on_failure(q, inv, now)
        self.index.note_pending_vt(q)
        self._update_state(q, now)

    def on_requeue(self, q: FlowQueue, now: float) -> None:
        """Re-activation after a front-of-queue re-insert. Unlike
        ``on_arrival`` there is no ``q.arrive`` — no IAT re-sample, no
        start-tag lift — the attempt already happened once."""
        self.index.note_pending_vt(q)
        self._update_state(q, now)

    # -- cross-shard virtual-time sync -----------------------------------------
    def min_pending_vt(self) -> Optional[float]:
        """This shard's contribution to the cross-shard Global_VT
        snapshot: the min pending start tag lifted to the local
        (monotone) Global_VT — i.e. exactly where ``_refresh_global_vt``
        would put the floor, read without mutating it."""
        vt = self.index.min_pending_vt()
        if vt is None:
            return None
        return vt if vt > self.global_vt else self.global_vt

    def raise_vt_floor(self, floor: float) -> None:
        """Epoch sync: adopt the cross-shard max-of-mins floor. Global_VT
        is monotone, so a stale (lower) floor is a no-op; throttled
        queues released by the raise fire at the next ``choose`` via the
        deferred-transition guard, exactly as after a local advance."""
        if floor > self.global_vt:
            self.global_vt = floor

    # -- executor integration --------------------------------------------------
    def next_expiry(self, now: float,
                    bound: Optional[float] = None) -> Optional[float]:
        """Earliest future anticipatory-TTL lapse; the SimExecutor arms a
        timer event at this time so Inactive transitions (and the memory
        swap-outs they drive) happen on schedule, not at the next
        arrival/completion that happens to rescan. ``bound`` (the
        executor's earliest already-armed timer) lets the index answer
        "nothing earlier" in O(1)."""
        return self.index.peek_next_expiry(now, self.alpha, bound)


class MQFQ(MQFQSticky):
    """Original MQFQ: arbitrary candidate choice (no sticky heuristic)."""
    name = "mqfq"

    def __init__(self, T: float = 10.0, alpha: float = 2.0, seed: int = 0):
        super().__init__(T=T, alpha=alpha, sticky=False, seed=seed)


class SFQ(MQFQSticky):
    """Classic start-time fair queueing: MQFQ-Sticky with a zero over-run
    budget (T=0), the paper's strict-fairness ablation."""
    name = "sfq"

    def __init__(self, alpha: float = 2.0, seed: int = 0):
        super().__init__(T=0.0, alpha=alpha, seed=seed)
