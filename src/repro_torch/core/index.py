"""Indexed scheduler state: the O(log F) hot-path structures.

The seed scheduler (kept verbatim in ``repro.core.reference``) rescans
every flow queue on each dispatch decision: refresh Global_VT with a
linear min, re-derive every queue's Active/Throttled/Inactive state, then
filter + sort candidates. That is O(F) per decision and caps the
simulator at toy scale. ``SchedulerIndex`` replaces each scan with a heap
under *lazy invalidation*: entries carry snapshots of the fields they
were keyed on, writers simply push fresh entries when a key changes, and
readers discard entries whose snapshot no longer matches the live queue.

Entries embed the ``FlowQueue`` object itself (queues are per-fn
singletons that live for the policy's lifetime), so validation is two
attribute compares — no ``queues[fn_id]`` dict lookup + string hash per
peek. ``FlowQueue`` uses identity eq/hash, which keeps the tuple
tie-compare O(1) when the same queue is snapshotted twice under an equal
key (``ins`` is unique, so entries of *different* queues never tie past
it).

Four indices, one invariant each ("every X has a current entry"):

  gvt heap       (vt, ins)     — queues with pending work; min = the
                                 Global_VT floor (min start tag of
                                 dispatchable flows).
  throttle heap  (vt, ins)     — THROTTLED queues ordered by VT. Because
                                 Global_VT is monotone non-decreasing and
                                 a throttled queue's VT is frozen (it
                                 cannot dispatch), eligibility is a
                                 monotone frontier: pop while the top is
                                 eligible.
  expiry heap    (due, ins)    — empty + no-in-flight queues awaiting the
                                 anticipatory TTL lapse. ``last_exec`` and
                                 ``iat`` are frozen while a queue stays
                                 idle, so one push at idle-entry suffices.
  candidate heaps              — ACTIVE queues with pending work, keyed
                                 (-len, ins) for D==1 ("longest queue
                                 first") and (in_flight, -len, ins) for
                                 D>1 (fewest-in-flight tie-break), exactly
                                 the reference's stable-sort order; ins
                                 (queue creation index) reproduces its
                                 dict-order tie-breaking bit-for-bit.

Stale entries are dropped on pop; if a heap still outgrows a small
multiple of the queue count (many pushes between pops), it is rebuilt
from live state — O(F) amortized over the pushes that caused it.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.flow import FlowQueue, QueueState


def _eligible(vt: float, global_vt: float, T: float) -> bool:
    """Eq. 1 eligibility (with the VT-floor work-conservation case).
    Mirrored element-wise by ``repro.batchsim.step``; exposed as
    ``eligible`` for the differential suite's cross-checks."""
    return vt < global_vt + T or vt <= global_vt


eligible = _eligible


def candidate_key(parallelism: int, qlen: int, in_flight: int,
                  ins: int) -> Tuple[int, ...]:
    """The sticky tie-break as a pure sort key: longest queue first with
    creation-order (``ins``) ties at D == 1, fewest-in-flight then
    longest-queue at D != 1 — exactly the order the candidate heaps
    below encode and ``best_candidate`` pops. The vectorized batch plane
    (``repro.batchsim.step``) reproduces this key with a masked
    lexicographic argmin; the differential suite cross-checks both
    against this function."""
    if parallelism == 1:
        return (-qlen, ins)
    return (in_flight, -qlen, ins)


class SchedulerIndex:
    def __init__(self, queues: Dict[str, FlowQueue]):
        self.queues = queues
        self.cand: set = set()          # FlowQueues: ACTIVE and len > 0
        self._gvt: List[Tuple[float, int, FlowQueue]] = []
        self._throttle: List[Tuple[float, int, FlowQueue]] = []
        self._expiry: List[Tuple[float, int, FlowQueue]] = []
        # candidate entries: (key..., queue, len_snap, inflight_snap)
        self._by_len: List[Tuple[int, int, FlowQueue, int, int]] = []
        self._by_inflight: List[
            Tuple[int, int, int, FlowQueue, int, int]] = []

    # -- write side: push fresh entries on key change -----------------------
    def note_pending_vt(self, q: FlowQueue) -> None:
        if q.pending:
            h = self._gvt
            heapq.heappush(h, (q.vt, q.ins, q))
            if len(h) > 64 + 4 * len(self.queues):   # compact, inlined
                self._gvt = [(qq.vt, qq.ins, qq)
                             for qq in self.queues.values() if qq.pending]
                heapq.heapify(self._gvt)

    def note_throttled(self, q: FlowQueue) -> None:
        heapq.heappush(self._throttle, (q.vt, q.ins, q))
        if len(self._throttle) > self._cap():
            self._throttle = [
                (qq.vt, qq.ins, qq) for qq in self.queues.values()
                if qq.state is QueueState.THROTTLED]
            heapq.heapify(self._throttle)

    def note_idle(self, q: FlowQueue, alpha: float) -> None:
        heapq.heappush(self._expiry,
                       (q.last_exec + q.ttl(alpha), q.ins, q))
        if len(self._expiry) > self._cap():
            self._expiry = [
                (qq.last_exec + qq.ttl(alpha), qq.ins, qq)
                for qq in self.queues.values()
                if not qq.pending and qq.in_flight == 0
                and qq.state is not QueueState.INACTIVE]
            heapq.heapify(self._expiry)

    def note_candidate(self, q: FlowQueue) -> None:
        """(Re-)index an ACTIVE queue with pending work under its current
        (len, in_flight) key; adds it to the candidate set."""
        self.cand.add(q)
        n, fl = len(q.pending), q.in_flight
        heapq.heappush(self._by_len, (-n, q.ins, q, n, fl))
        heapq.heappush(self._by_inflight, (fl, -n, q.ins, q, n, fl))
        self._maybe_compact_cand()

    def drop_candidate(self, q: FlowQueue) -> None:
        self.cand.discard(q)            # heap entries die by validation

    # -- read side: validate-and-discard peeks ------------------------------
    # NOTE two reads live inlined in MQFQSticky for frame-count reasons
    # (they run 1.5-3x per event): the Global_VT floor walk (min VT over
    # queues with pending work, validating gvt-heap tops) is inside
    # ``_refresh_global_vt``, and the O(1) deferred-transition guard
    # (raw expiry/throttle heap tops as lower bounds) is inside
    # ``choose`` — see the exactness argument there.

    def pop_due_expiries(self, now: float, alpha: float
                         ) -> Iterator[FlowQueue]:
        """Queues whose anticipatory TTL has lapsed by ``now``."""
        h = self._expiry
        while h and h[0][0] <= now:
            due, _, q = heapq.heappop(h)
            if q.pending or q.in_flight \
                    or q.state is QueueState.INACTIVE:
                continue                # stale: queue revived or expired
            true_due = q.last_exec + q.ttl(alpha)
            if true_due > now:          # key drifted; requeue corrected
                heapq.heappush(h, (true_due, q.ins, q))
                continue
            yield q

    def pop_unthrottled(self, global_vt: float, T: float
                        ) -> Iterator[FlowQueue]:
        """Throttled queues made eligible by the current Global_VT. The
        heap min is the true min VT over throttled queues, so once the top
        is ineligible every deeper entry is too."""
        h = self._throttle
        while h:
            vt, _, q = h[0]
            if q.state is not QueueState.THROTTLED or q.vt != vt:
                heapq.heappop(h)        # stale
                continue
            if not _eligible(vt, global_vt, T):
                return
            heapq.heappop(h)
            yield q

    def min_pending_vt(self) -> Optional[float]:
        """Raw min VT over queues with pending work (validate-and-discard
        on the gvt heap), or None when nothing is pending. The shard-sync
        export: ``Policy.min_pending_vt`` lifts it to the policy's
        monotone Global_VT before publication."""
        h = self._gvt
        while h:
            vt, _, q = h[0]
            if q.pending and q.vt == vt:
                return vt
            heapq.heappop(h)
        return None

    def best_candidate(self, parallelism: int) -> Optional[FlowQueue]:
        """The reference's ``cand[0]`` after its stable sorts: max-len
        (ins tie-break) at D==1, min-in-flight-then-max-len at D!=1. The
        winning entry stays in the heap; a dispatch changes its key and
        strands it as stale."""
        h = self._by_len if parallelism == 1 else self._by_inflight
        cand = self.cand
        while h:
            entry = h[0]
            q, n, fl = entry[-3], entry[-2], entry[-1]
            if q in cand and len(q.pending) == n and q.in_flight == fl:
                return q
            heapq.heappop(h)
        return None

    def candidates_in_creation_order(self) -> List[FlowQueue]:
        """Exact candidate list in queue-creation (dict) order — the list
        the reference hands to ``rng.choice`` for plain MQFQ."""
        qs = list(self.cand)
        qs.sort(key=lambda q: q.ins)
        return qs

    # -- compaction: bound heap growth to O(#queues) ------------------------
    def _cap(self) -> int:
        return 64 + 4 * len(self.queues)

    def _maybe_compact_cand(self) -> None:
        if len(self._by_len) > self._cap():
            ent = [(q, len(q.pending), q.in_flight) for q in self.cand]
            self._by_len = [(-n, q.ins, q, n, fl)
                            for q, n, fl in ent]
            self._by_inflight = [(fl, -n, q.ins, q, n, fl)
                                 for q, n, fl in ent]
            heapq.heapify(self._by_len)
            heapq.heapify(self._by_inflight)

    def peek_next_expiry(self, now: float, alpha: float,
                         bound: Optional[float] = None) -> Optional[float]:
        """Earliest strictly-future TTL lapse (for executor timers).

        ``bound``: the caller's currently-armed earliest timer. Entry
        keys lower-bound the true dues (an idle queue's freshest entry
        equals its frozen true due; stale keys only under-shoot), so
        when the raw heap top is already >= bound no expiry could need
        arming and the validation walk is skipped entirely — this turns
        the executor's per-event timer peek into an O(1) check."""
        h = self._expiry
        if bound is not None and h and h[0][0] >= bound:
            return None
        deferred = []
        result: Optional[float] = None
        while h:
            due, _, q = h[0]
            if q.pending or q.in_flight \
                    or q.state is QueueState.INACTIVE:
                heapq.heappop(h)
                continue
            true_due = q.last_exec + q.ttl(alpha)
            if true_due != due:
                heapq.heappop(h)
                heapq.heappush(h, (true_due, q.ins, q))
                continue
            if due <= now:              # due-but-unfired: skip past it
                deferred.append(heapq.heappop(h))
                continue
            result = due
            break
        for e in deferred:
            heapq.heappush(h, e)
        return result
