"""Contended transfer link: processor sharing with demand priority.

Transfers in flight share the link's bandwidth; completion times are
re-planned on every entry/exit/upgrade, in the same event-driven style
as the executors (``_progress`` integrates work done since the last
mutation, ``_replan`` projects new completion etas).

Two transfer classes (FaaSTube's bandwidth allocation, collapsed to a
strict two-level hierarchy):

    demand    — a dispatched invocation is waiting on these bytes;
                demand transfers split the link equally among themselves
    prefetch  — anticipatory background uploads; they run only while NO
                demand transfer is active, and are paused (eta = inf)
                otherwise

so a background prefetch can never slow a dispatch's critical-path
transfer below its no-prefetch bandwidth.

Within the prefetch class the link serves ONE transfer at a time, in
ascending ``prio`` order (a DMA copy engine streams background copies
back-to-back; splitting it N ways would finish nothing before the
scheduler needs it). The control plane supplies ``prio`` from the
policy's stable dispatch tie-break (queue creation order), so prefetches
complete in the order flows are expected to dispatch and the pipeline
stays ahead of the drain instead of thrashing.

The same class models the per-device host->HBM (PCIe) leg AND the
peer-to-peer interconnect legs of the fabric (``repro.datapath.fabric``)
— one ``SharedLink`` per directed device pair.

Hot-path bookkeeping: the demand count, the serving-prefetch pointer
and the earliest planned eta are *cached* and maintained incrementally
across mutations, so ``_progress``/``_replan``/``next_eta`` no longer
re-scan ``active`` on every event. The pre-change scanning bodies are
kept verbatim below (``*_scan`` / ``_serving_prefetch``) and bound by
``ReferenceSharedLink`` — the differential reference proven equivalent
by tests/test_fabric.py's conservation fuzz.

Chunk milestones (FaaSTube layer streaming): a transfer may carry one
*milestone* — a remaining-bytes threshold at which ``chunk_waiters``
fire so execution can begin when the first ``chunk_bytes`` land while
the residual keeps streaming on the same link in the same class.
"""
from __future__ import annotations

from typing import List, Optional

INF = float("inf")

# completion slack: float integration of piecewise-constant shares loses
# ~ulp(nbytes) per replan; half a byte absorbs that without ever letting
# a materially-incomplete transfer slip through
_EPS_BYTES = 0.5


class Transfer:
    __slots__ = ("fn_id", "nbytes", "remaining", "eta", "kind", "prio",
                 "waiters", "queued", "src", "chunk_rem", "chunk_eta",
                 "chunk_waiters")

    def __init__(self, fn_id: str, nbytes: int, kind: str,
                 prio: float = 0.0, src: Optional[int] = None):
        self.fn_id = fn_id
        self.nbytes = int(nbytes)
        self.remaining = float(nbytes)
        self.eta = INF           # planned completion; inf while paused/queued
        self.kind = kind         # "demand" | "prefetch"
        self.prio = prio         # prefetch service order (lower = sooner)
        self.waiters: List = []  # callables(t_done): dispatched invocations
        self.queued = False      # blocked on the staging pool, not on link
        # peer migration: source device id when the bytes stream from a
        # peer's HBM over the fabric instead of host DRAM (None = host)
        self.src = src
        # chunk milestone: fire chunk_waiters once remaining <= chunk_rem
        # (None = no milestone armed); chunk_eta is its planned time
        self.chunk_rem: Optional[float] = None
        self.chunk_eta = INF
        self.chunk_waiters: List = []


class SharedLink:
    """One contended transfer link (H2D/PCIe, or one fabric direction)."""

    __slots__ = ("bw", "active", "_last", "_n_demand", "_serving",
                 "_next_eta", "_n_miles")

    def __init__(self, bw: float):
        self.bw = float(bw)
        self.active: List[Transfer] = []
        self._last = 0.0         # virtual time of the last integration
        # incremental caches (see module docstring); the *_scan bodies
        # below are the retained pre-change reference
        self._n_demand = 0       # demand transfers in ``active``
        self._serving: Optional[Transfer] = None   # min-prio non-demand
        self._next_eta: Optional[float] = None     # earliest finite eta
        self._n_miles = 0        # transfers with an armed milestone

    # -- processor sharing -------------------------------------------------
    def _serving_prefetch(self) -> Optional[Transfer]:
        """The one prefetch the link streams while no demand is active:
        lowest prio, insertion order breaking ties. (Only meaningful —
        and only called — when no demand transfer is active, so every
        entry of ``active`` is a prefetch.) Pre-change scanning body,
        used by the cache rebuild and the reference link."""
        best = None
        for t in self.active:
            if best is None or t.prio < best.prio:
                best = t
        return best

    def _reserve(self) -> None:
        """Rebuild the serving-prefetch pointer after the cached one
        left the link (or was upgraded to demand)."""
        best = None
        for t in self.active:
            if t.kind != "demand" and (best is None or t.prio < best.prio):
                best = t
        self._serving = best

    def _progress(self, now: float) -> None:
        """Integrate bytes moved since the last mutation under the
        share split that held over [._last, now)."""
        dt = now - self._last
        if dt <= 0.0:
            return
        n_demand = self._n_demand
        if n_demand:
            moved = self.bw * dt / n_demand
            for t in self.active:
                if t.kind == "demand":
                    t.remaining -= moved
        else:
            serving = self._serving
            if serving is not None:
                serving.remaining -= self.bw * dt
        self._last = now

    def _replan(self) -> None:
        """Project completion (and milestone) etas under the current
        share split, refreshing the earliest-eta cache."""
        act = self.active
        if not act:
            self._next_eta = None
            return
        best = INF
        if self._n_demand:
            per = self.bw / self._n_demand
            for t in act:
                if t.kind == "demand":
                    rem = t.remaining
                    e = self._last + (rem if rem > 0.0 else 0.0) / per
                    t.eta = e
                    if t.chunk_rem is not None:
                        d = rem - t.chunk_rem
                        e = self._last + (d if d > 0.0 else 0.0) / per
                        t.chunk_eta = e
                    if e < best:
                        best = e
                else:
                    t.eta = INF          # paused behind demand traffic
                    if t.chunk_rem is not None:
                        t.chunk_eta = INF
        else:
            serving = self._serving
            bw = self.bw
            for t in act:
                if t is serving:
                    rem = t.remaining
                    e = self._last + (rem if rem > 0.0 else 0.0) / bw
                    t.eta = e
                    if t.chunk_rem is not None:
                        d = rem - t.chunk_rem
                        e = self._last + (d if d > 0.0 else 0.0) / bw
                        t.chunk_eta = e
                    if e < best:
                        best = e
                else:
                    t.eta = INF          # behind the serving prefetch
                    if t.chunk_rem is not None:
                        t.chunk_eta = INF
        self._next_eta = best if best < INF else None

    # -- pre-change scanning bodies (differential reference) ---------------
    def _progress_scan(self, now: float) -> None:
        """Pre-change ``_progress``: recount the demand class and rescan
        for the serving prefetch on every integration."""
        dt = now - self._last
        if dt <= 0.0:
            return
        act = self.active
        if act:
            n_demand = 0
            for t in act:
                if t.kind == "demand":
                    n_demand += 1
            if n_demand:
                moved = self.bw * dt / n_demand
                for t in act:
                    if t.kind == "demand":
                        t.remaining -= moved
            else:
                serving = self._serving_prefetch()
                if serving is not None:
                    serving.remaining -= self.bw * dt
        self._last = now

    def _replan_scan(self) -> None:
        """Pre-change ``_replan``: fresh demand recount + serving rescan
        per projection (milestone etas added so the reference stays a
        complete implementation of the new surface)."""
        act = self.active
        if not act:
            return
        n_demand = 0
        for t in act:
            if t.kind == "demand":
                n_demand += 1
        if n_demand:
            per = self.bw / n_demand
            for t in act:
                if t.kind == "demand":
                    rem = t.remaining
                    t.eta = self._last + (rem if rem > 0.0 else 0.0) / per
                    if t.chunk_rem is not None:
                        d = rem - t.chunk_rem
                        t.chunk_eta = self._last + (d if d > 0.0
                                                    else 0.0) / per
                else:
                    t.eta = INF          # paused behind demand traffic
                    if t.chunk_rem is not None:
                        t.chunk_eta = INF
        else:
            serving = self._serving_prefetch()
            for t in act:
                if t is serving:
                    rem = t.remaining
                    t.eta = self._last + (rem if rem > 0.0 else 0.0) \
                        / self.bw
                    if t.chunk_rem is not None:
                        d = rem - t.chunk_rem
                        t.chunk_eta = self._last + (d if d > 0.0
                                                    else 0.0) / self.bw
                else:
                    t.eta = INF          # behind the serving prefetch
                    if t.chunk_rem is not None:
                        t.chunk_eta = INF

    def next_eta_scan(self) -> Optional[float]:
        """Pre-change ``next_eta``: full scan for the earliest finite
        planned completion or milestone."""
        best = None
        for t in self.active:
            e = t.eta
            if t.chunk_eta < e:
                e = t.chunk_eta
            if e < INF and (best is None or e < best):
                best = e
        return best

    # -- mutations ---------------------------------------------------------
    def add(self, t: Transfer, now: float) -> None:
        self._progress(now)
        self.active.append(t)
        if t.kind == "demand":
            self._n_demand += 1
        elif self._serving is None or t.prio < self._serving.prio:
            self._serving = t
        if t.chunk_rem is not None:
            self._n_miles += 1
        self._replan()

    def remove(self, t: Transfer, now: float) -> None:
        self._progress(now)
        self.active.remove(t)
        if t.kind == "demand":
            self._n_demand -= 1
        elif t is self._serving:
            self._reserve()
        if t.chunk_rem is not None:
            self._n_miles -= 1
        self._replan()

    def mark_demand(self, t: Transfer, now: float) -> None:
        self._progress(now)
        t.kind = "demand"
        self._n_demand += 1
        if t is self._serving:
            self._reserve()
        self._replan()

    def arm_milestone(self, t: Transfer, chunk_rem: float,
                      now: float) -> None:
        """Arm a chunk milestone: ``chunk_waiters`` fire once
        ``remaining <= chunk_rem`` (chunked layer streaming — execution
        starts at the first chunk, the residual keeps streaming)."""
        self._progress(now)
        if t.chunk_rem is None:
            self._n_miles += 1
        t.chunk_rem = chunk_rem
        self._replan()

    def pop_completed(self, now: float) -> List[Transfer]:
        """Advance to ``now`` and detach every finished transfer."""
        self._progress(now)
        act = self.active
        done = [t for t in act if t.remaining <= _EPS_BYTES]
        if done:
            self.active = [t for t in act if t.remaining > _EPS_BYTES]
            reserve = False
            for t in done:
                if t.kind == "demand":
                    self._n_demand -= 1
                elif t is self._serving:
                    reserve = True
                if t.chunk_rem is not None:
                    self._n_miles -= 1
                    t.chunk_rem = None
                    t.chunk_eta = INF
            if reserve:
                self._reserve()
            self._replan()
        return done

    def pop_milestones(self, now: float) -> List[Transfer]:
        """Advance to ``now`` and detach every crossed chunk milestone
        (the transfers stay active — only their milestone is consumed).
        Zero-cost when no milestone is armed."""
        if not self._n_miles:
            return []
        self._progress(now)
        hit = []
        for t in self.active:
            cr = t.chunk_rem
            if cr is not None and t.remaining <= cr + _EPS_BYTES:
                t.chunk_rem = None
                t.chunk_eta = INF
                self._n_miles -= 1
                hit.append(t)
        if hit:
            self._replan()
        return hit

    def next_eta(self) -> Optional[float]:
        """Earliest planned completion or milestone (None when idle or
        all paused). O(1): maintained by ``_replan``."""
        return self._next_eta

    # -- placement estimates (time-to-resident bids) ------------------------
    def backlog_bytes(self) -> float:
        """Outstanding demand-class bytes: the work a new demand
        transfer would share the link with (placement bid input)."""
        total = 0.0
        for t in self.active:
            if t.kind == "demand":
                total += t.remaining
        return total


class ReferenceSharedLink(SharedLink):
    """The pre-change link: scanning ``_progress``/``_replan``/
    ``next_eta`` bodies, no incremental caches on the read paths. Kept
    as the differential reference — tests/test_fabric.py replays random
    mutation programs through both classes and asserts bit-identical
    remaining/eta/completion sequences."""
    __slots__ = ()
    _progress = SharedLink._progress_scan
    _replan = SharedLink._replan_scan
    next_eta = SharedLink.next_eta_scan
