"""Integrated device-memory management (paper §4.3, Fig. 4) — indexed.

Queue states drive data placement: Active -> prefetch the function's
regions to device memory; Throttled/Inactive -> mark evictable and swap
out asynchronously in LRU order.

Policies (Fig. 4 spectrum, adapted from CUDA UVM to an explicit HBM pool,
see DESIGN.md §2):
  ondemand      — nothing moves ahead of time; non-resident bytes are paged
                  in during execution (exec-time stretch, like stock UVM)
  madvise       — placement hints only: pays a per-dispatch directive
                  overhead, no actual movement (paper: worse than ondemand)
  prefetch      — async upload on queue activation; no proactive eviction,
                  reclaim only under pressure (thrash penalty when over)
  prefetch_swap — paper default: async upload on activation + async LRU
                  swap-out on throttle/inactive

This is the O(log R)-per-miss implementation: ``_evict_lru`` pops
lazy-invalidation heaps instead of re-sorting every region per miss. The
seed's linear-scan manager is kept verbatim in ``repro.memory.reference``
as the executable specification; ``tests/test_memory_equivalence.py``
proves bit-identical eviction order, admission decisions and byte
accounting. Two details carry the equivalence:

  - Heap keys are (last_use, creation index): Python's stable sort broke
    last_use ties by ``regions`` dict order, i.e. region creation order.
  - When the evictable pool cannot satisfy a request, the reference
    re-walks its *pre-eviction* resident snapshot — re-counting the
    regions it just swapped out. ``_evict_resident_sweep`` replays that
    second pass (including the duplicate accounting) by merging the
    phase-1 victim list with the resident heap, so the fallback is
    bug-for-bug identical and still O(log R) per swept region.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

GB = 1024 ** 3

# Host->device paging is slower than bulk DMA (page-fault handling);
# stock-UVM executions in the paper ran ~40% worse at 50% oversubscription.
ONDEMAND_PENALTY = 2.5
MADVISE_DISPATCH_OVERHEAD = 0.050  # s of wasted directive traffic
THRASH_PENALTY = 1.5


@dataclass(slots=True)
class Region:
    fn_id: str
    size: int
    resident: bool = False
    upload_eta: float = -1.0   # >now while async upload in flight
    evictable: bool = False
    last_use: float = 0.0
    ins: int = 0               # creation index: the stable-sort tie-break


class DeviceMemoryManager:
    def __init__(self, capacity_bytes: int = 16 * GB,
                 h2d_bw: float = 100 * GB,  # bytes/s DMA
                 policy: str = "prefetch_swap",
                 strict_reclaim: bool = True):
        assert policy in ("ondemand", "madvise", "prefetch", "prefetch_swap")
        self.capacity = capacity_bytes
        self.h2d_bw = h2d_bw
        self.policy = policy
        # True (default): the second-pass resident sweep replays the
        # seed's pre-snapshot semantics bug-for-bug, re-counting the
        # phase-1 victims (see _evict_resident_sweep). False: the sweep
        # walks only regions still resident — each victim is evicted
        # (and its bytes counted, listeners notified) exactly once.
        self.strict_reclaim = strict_reclaim
        # policy predicates, precomputed off the per-dispatch acquire path
        self._paged = policy in ("ondemand", "madvise")
        self._madvise = policy == "madvise"
        self._prefetch_only = policy == "prefetch"
        # cold-start data plane (repro.datapath): when set, upload etas
        # come from the device's contended-link planner instead of the
        # point estimate size / h2d_bw. Signature: (fn_id, size, now,
        # kind) -> planned completion eta ("prefetch" | "demand").
        self.uploader = None
        # False suppresses the activation-time anticipatory upload (the
        # pipeline datapath's keep-alive-only baseline); acquire-time
        # demand uploads are unaffected
        self.anticipatory_upload = True
        self.regions: Dict[str, Region] = {}
        # notified with fn_id whenever a region is swapped out; the
        # wall-clock executor mirrors these onto real endpoints
        self.evict_listeners: List = []
        # accounting
        self.bytes_uploaded = 0
        self.bytes_evicted = 0
        self.prefetch_count = 0
        self._used = 0          # running sum of resident region sizes
        # LRU indices under lazy invalidation (the core/index.py pattern):
        # entries are (last_use, ins, fn_id) snapshots; writers push fresh
        # entries whenever a key field changes, readers discard entries
        # whose snapshot no longer matches the live region.
        self._evict_heap: List[Tuple[float, int, str]] = []   # resident+evictable
        self._resident_heap: List[Tuple[float, int, str]] = []  # resident

    # -- bookkeeping ------------------------------------------------------
    def region(self, fn_id: str, size: int) -> Region:
        r = self.regions.get(fn_id)
        if r is None:
            r = Region(fn_id, size, ins=len(self.regions))
            self.regions[fn_id] = r
        if r.size != size:
            if r.resident:
                self._used += size - r.size
            r.size = size
        return r

    def _set_resident(self, r: Region, resident: bool) -> None:
        if r.resident != resident:
            self._used += r.size if resident else -r.size
            r.resident = resident
            if resident:
                self._reindex(r)

    def _reindex(self, r: Region) -> None:
        """Push fresh heap entries for a region whose LRU key (residency,
        evictability, last_use) just changed. Old entries die by
        validation on pop; compaction bounds heap growth."""
        if not r.resident:
            return
        entry = (r.last_use, r.ins, r.fn_id)
        heapq.heappush(self._resident_heap, entry)
        if r.evictable:
            heapq.heappush(self._evict_heap, entry)
        if len(self._resident_heap) > self._cap() \
                or len(self._evict_heap) > self._cap():
            self._compact()

    def _cap(self) -> int:
        return 64 + 4 * len(self.regions)

    def _compact(self) -> None:
        live = [(r.last_use, r.ins, r.fn_id)
                for r in self.regions.values() if r.resident]
        self._resident_heap = live
        heapq.heapify(self._resident_heap)
        self._evict_heap = [
            e for e in live if self.regions[e[2]].evictable]
        heapq.heapify(self._evict_heap)

    @property
    def used(self) -> int:
        return self._used

    def free_bytes(self) -> int:
        return self.capacity - self._used

    # -- eviction -----------------------------------------------------------
    def _evict_one(self, r: Region) -> None:
        self._set_resident(r, False)
        r.upload_eta = -1.0
        self.bytes_evicted += r.size
        self._notify_evict(r.fn_id)

    def _evict_lru(self, need: int, now: float,
                   protect: Tuple[str, ...] = (),
                   evictable_only: bool = False) -> bool:
        """Free >= need bytes by swapping out evictable (then any)
        resident regions in LRU order. Swap-out is async (off the critical
        path), so capacity is released immediately. O(log R) per evicted
        region on the common (evictable-satisfies) path.
        ``evictable_only`` skips the resident fallback — background
        prefetches (``begin_prefetch``) may only reclaim what the state
        machine already marked reclaimable."""
        if self.free_bytes() >= need:
            return True
        victims: List[Region] = []
        skipped: List[Tuple[float, int, str]] = []
        h = self._evict_heap
        while self.free_bytes() < need and h:
            lu, ins, fn = h[0]
            r = self.regions.get(fn)
            if r is None or not r.resident or not r.evictable \
                    or r.last_use != lu:
                heapq.heappop(h)        # stale
                continue
            if fn in protect:
                skipped.append(heapq.heappop(h))
                continue
            heapq.heappop(h)
            self._evict_one(r)
            victims.append(r)
        for e in skipped:
            heapq.heappush(h, e)
        if self.free_bytes() >= need:
            return True
        if evictable_only:
            return False
        if self.strict_reclaim:
            return self._evict_resident_sweep(need, victims, protect)
        return self._evict_resident_clean(need, protect)

    def _evict_resident_sweep(self, need: int, victims: List[Region],
                              protect: Tuple[str, ...]) -> bool:
        """Second pass: the evictable pool could not satisfy the request.
        The reference walks its resident snapshot taken BEFORE phase 1,
        so the phase-1 victims are re-processed (their eviction is a
        residency no-op but the byte accounting and listener callbacks
        fire again). Replay that snapshot exactly by merging the victim
        list (already in (last_use, ins) pop order) with the resident
        heap — O(log R) per swept region instead of re-listing and
        re-sorting every region."""
        h = self._resident_heap
        skipped: List[Tuple[float, int, str]] = []
        vi = 0
        ok = False
        while True:
            top: Optional[Region] = None
            while h:
                lu, ins, fn = h[0]
                r = self.regions.get(fn)
                if r is None or not r.resident or r.last_use != lu:
                    heapq.heappop(h)    # stale
                    continue
                if fn in protect:
                    skipped.append(heapq.heappop(h))
                    continue
                top = r
                break
            victim = victims[vi] if vi < len(victims) else None
            if victim is not None and (
                    top is None
                    or (victim.last_use, victim.ins) <= (top.last_use,
                                                         top.ins)):
                vi += 1
                self._evict_one(victim)     # duplicate accounting, as in
            elif top is not None:           # the reference's stale pool2
                heapq.heappop(h)
                self._evict_one(top)
            else:
                break
            if self.free_bytes() >= need:
                ok = True
                break
        for e in skipped:
            heapq.heappush(h, e)
        return ok or self.free_bytes() >= need

    def _evict_resident_clean(self, need: int,
                              protect: Tuple[str, ...]) -> bool:
        """Second pass, ``strict_reclaim=False``: sweep only the regions
        still resident after phase 1. Phase-1 victims are already
        non-resident, so their heap entries fail validation — no
        duplicate byte accounting, no duplicate evict-listener
        callbacks. Still O(log R) per swept region."""
        h = self._resident_heap
        skipped: List[Tuple[float, int, str]] = []
        while self.free_bytes() < need:
            r: Optional[Region] = None
            while h:
                lu, ins, fn = h[0]
                cand = self.regions.get(fn)
                if cand is None or not cand.resident or cand.last_use != lu:
                    heapq.heappop(h)    # stale (incl. phase-1 victims)
                    continue
                if fn in protect:
                    skipped.append(heapq.heappop(h))
                    continue
                r = cand
                break
            if r is None:
                break
            heapq.heappop(h)
            self._evict_one(r)
        for e in skipped:
            heapq.heappush(h, e)
        return self.free_bytes() >= need

    def _notify_evict(self, fn_id: str) -> None:
        for cb in self.evict_listeners:
            cb(fn_id)

    def _upload_eta(self, fn_id: str, size: int, now: float,
                    kind: str) -> float:
        """Planned completion of an upload starting now: the contended
        link's plan when a datapath is wired, else the scalar point
        estimate (the seed's model)."""
        if self.uploader is not None:
            return self.uploader(fn_id, size, now, kind)
        return now + size / self.h2d_bw

    # -- scheduler hooks ------------------------------------------------------
    def on_queue_active(self, fn_id: str, size: int, now: float) -> None:
        """Anticipatory prefetch when a queue becomes active (§4.3)."""
        r = self.region(fn_id, size)
        r.evictable = False
        if self.policy not in ("prefetch", "prefetch_swap"):
            return
        if not self.anticipatory_upload:
            return      # keep-alive-only baseline: upload at dispatch
        if r.resident or r.upload_eta > now:
            return
        if not self._evict_lru(r.size, now, protect=(fn_id,)):
            return  # no space: upload will happen at dispatch
        r.upload_eta = self._upload_eta(fn_id, r.size, now, "prefetch")
        self._set_resident(r, True)   # reserved now, usable at upload_eta
        self.prefetch_count += 1
        self.bytes_uploaded += r.size

    def begin_prefetch(self, fn_id: str, size: int, now: float) -> bool:
        """Drain-pass anticipatory prefetch (pipeline datapath): start
        uploading a queued-but-not-dispatchable flow's weights. Unlike
        activation prefetch the region stays *evictable* — it is charged
        capacity through the normal accounting but never protects itself
        against a dispatching flow's reclaim — and only the already-
        evictable pool may be displaced to make room."""
        if self.policy not in ("prefetch", "prefetch_swap"):
            return False
        r = self.region(fn_id, size)
        if r.resident:
            return False
        if not self._evict_lru(r.size, now, protect=(fn_id,),
                               evictable_only=True):
            return False
        r.upload_eta = self._upload_eta(fn_id, r.size, now, "prefetch")
        r.evictable = True
        self._set_resident(r, True)
        self.prefetch_count += 1
        self.bytes_uploaded += r.size
        return True

    # -- datapath callbacks ---------------------------------------------------
    def set_upload_eta(self, fn_id: str, eta: float) -> None:
        """Link replan: mirror a transfer's new planned completion (inf
        while paused/queued) so ``is_resident`` stays truthful."""
        r = self.regions.get(fn_id)
        if r is not None and r.resident:
            r.upload_eta = eta

    def finish_upload(self, fn_id: str, now: float) -> None:
        """A transfer's bytes landed: the region is usable from now."""
        r = self.regions.get(fn_id)
        if r is not None and r.resident:
            r.upload_eta = now

    def drop_region(self, fn_id: str) -> None:
        """Release a resident region through the eviction path (bytes
        counted, listeners notified once): used when a prefetch is
        cancelled on an Inactive transition."""
        r = self.regions.get(fn_id)
        if r is not None and r.resident:
            self._evict_one(r)

    def invalidate_device(self) -> int:
        """Fault plane: the device died — every resident region's bytes
        are gone. Evict them all through the normal path (bytes counted,
        listeners notified once each, so the wall-clock executor mirrors
        the loss onto real endpoints), clear any in-flight upload etas,
        and rebuild the LRU heaps. Returns the number of regions
        invalidated."""
        n = 0
        for r in self.regions.values():
            if r.resident:
                self._evict_one(r)
                n += 1
            elif r.upload_eta > 0.0:
                r.upload_eta = -1.0
        self._compact()
        return n

    def on_queue_idle(self, fn_id: str, now: float) -> None:
        """Throttled/Inactive: mark for (async) LRU eviction."""
        r = self.regions.get(fn_id)
        if r is None:
            return
        became_evictable = not r.evictable
        r.evictable = True
        if self.policy == "prefetch_swap":
            # async swap-out; capacity released immediately, write-back
            # is off the critical path
            if r.resident and r.upload_eta <= now:
                self._evict_one(r)
                return
        if became_evictable and r.resident:
            self._reindex(r)

    # -- dispatch-time ---------------------------------------------------------
    def admit(self, fn_id: str, size: int, running, now: float) -> bool:
        """Memory admission control (§4.4): dispatch only if the working
        sets of running functions + this one fit physical memory.
        ``running`` is the pre-summed distinct-running-function byte count
        the control plane maintains (O(1)), or the seed's fn_id -> bytes
        dict."""
        reserved = (running if isinstance(running, (int, float))
                    else sum(running.values())) + size
        return reserved <= self.capacity

    def acquire(self, fn_id: str, size: int, now: float
                ) -> Tuple[float, float]:
        """Make fn resident for execution. Returns (ready_time,
        exec_multiplier): ready_time is when data is on device; the
        multiplier stretches execution for paging-style policies."""
        r = self.regions.get(fn_id)
        if r is None or r.size != size:
            r = self.region(fn_id, size)
        r.evictable = False
        if r.last_use != now:
            r.last_use = now
            self._reindex(r)           # fresh LRU key while resident
        if self._paged:
            # pages migrate on first touch during execution
            if not r.resident:
                self._evict_lru(r.size, now, protect=(fn_id,))
                self._set_resident(r, True)
                self.bytes_uploaded += r.size
                mult_bytes = r.size / self.h2d_bw
                # stretch execution instead of upfront wait
                return (now + (MADVISE_DISPATCH_OVERHEAD
                               if self._madvise else 0.0),
                        1.0 + ONDEMAND_PENALTY * mult_bytes)
            if self._madvise:
                return now + MADVISE_DISPATCH_OVERHEAD, 1.0
            return now, 1.0
        # prefetch / prefetch_swap
        if r.resident:
            upload_eta = r.upload_eta
            return (upload_eta if upload_eta > now else now), 1.0
        # miss: synchronous upload on the critical path
        mult = 1.0
        needed_eviction = self.free_bytes() < r.size
        self._evict_lru(r.size, now, protect=(fn_id,))
        if self._prefetch_only and needed_eviction:
            # no proactive swap-out: reclaim happens lazily during
            # execution (UVM-style page-out on demand) -> exec stretch
            mult = THRASH_PENALTY
        self._set_resident(r, True)
        r.upload_eta = self._upload_eta(fn_id, r.size, now, "demand")
        self.bytes_uploaded += r.size
        return r.upload_eta, mult

    def is_resident(self, fn_id: str, now: float) -> bool:
        r = self.regions.get(fn_id)
        return bool(r and r.resident and r.upload_eta <= now)

    def time_to_resident(self, fn_id: str, now: float) -> Optional[float]:
        """Predicted seconds until fn's weights are usable here: 0.0
        when resident, the remaining planned upload time when a transfer
        is in flight with a finite eta, None when the caller must
        estimate from the link model (region absent, or its transfer is
        paused/staging-queued with no planned completion). Placement-bid
        input for ``placement="time-to-resident"``."""
        r = self.regions.get(fn_id)
        if r is None or not r.resident:
            return None
        eta = r.upload_eta
        if eta <= now:
            return 0.0
        if eta == float("inf"):
            return None
        return eta - now
