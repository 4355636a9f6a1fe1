"""Container warm pool (paper §4.2 "Container Warm-pool", Fig. 8c) — indexed.

A *container* here is an initialized endpoint instance: the model's
compiled executable + host-side weights (the FaaS "initialized process").
Whether its weights are on-device is the memory manager's concern — the
pool only answers "does an initialized instance exist?", giving the three
start types:

  warm       — idle container exists AND weights device-resident
  host_warm  — idle container exists, weights swapped out ("GPU-cold but
               host-warm" in the paper)
  cold       — no container: pay full initialization

Hot paths are heap-indexed with lazy invalidation (the core/index.py
pattern): per-fn idle free lists are heaps keyed by most-recent use,
pool-wide LRU eviction pops one global heap instead of flattening every
idle list, and ``count`` reads O(1) per-fn counters. The seed's
linear-scan pool is kept verbatim in ``repro.memory.reference``;
``tests/test_memory_equivalence.py`` proves bit-identical behavior. The
tie-breaks that carry the equivalence:

  - within a function: the reference picked the first-listed container
    among equal ``last_use`` -> secondary key is the monotone release
    sequence number;
  - across functions (global LRU): the reference's ``min`` over the
    flattened lists resolved ties by ``_idle_by_fn`` dict order (first
    release since the last ``evict_fn``), then list position -> composite
    key (last_use, fn insertion stamp, release seq).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(eq=False, slots=True)   # identity semantics: two containers of
class Container:              # the same fn created at the same instant are
    fn_id: str                # field-identical but distinct; removal must
    created: float            # never pick the twin
    last_use: float
    busy: bool = False
    idle_seq: int = -1        # release seq of the current idle stint
                              # (-1 while busy/evicted): heap-entry validity


class WarmPool:
    def __init__(self, max_containers: int = 32):
        self.max_containers = max_containers
        # per-fn idle free lists: heaps of (-last_use, seq, container),
        # valid iff container.idle_seq == seq
        self._idle_heaps: Dict[str, List[Tuple[float, int, Container]]] = {}
        # pool-wide LRU: (last_use, fn_stamp, seq, container)
        self._lru_heap: List[Tuple[float, int, int, Container]] = []
        self._seq = itertools.count()        # global release sequence
        # mirrors the reference's _idle_by_fn dict-key insertion order:
        # assigned at a fn's first release since creation/evict_fn
        self._fn_stamp: Dict[str, int] = {}
        self._stamp = itertools.count()
        # O(1) counters (satellite: count() was an O(pool) scan)
        self._count_by_fn: Dict[str, int] = {}   # all containers, busy+idle
        self._idle_by_fn: Dict[str, int] = {}    # idle only
        self._total = 0
        self._n_idle = 0
        # creation-ordered registry (dict-as-ordered-set), so the
        # ``containers`` view matches the reference's list order
        self._live: Dict[Container, None] = {}
        # stats
        self.cold_starts = 0
        self.warm_starts = 0
        self.host_warm_starts = 0
        self.evictions = 0
        self.destroyed = 0      # fault plane: containers killed outright

    # -- introspection ------------------------------------------------------
    @property
    def containers(self) -> List[Container]:
        return list(self._live)

    def count(self, fn_id: Optional[str] = None) -> int:
        if fn_id is None:
            return self._total
        return self._count_by_fn.get(fn_id, 0)

    # -- idle index ---------------------------------------------------------
    def _idle(self, fn_id: str) -> Optional[Container]:
        """Most-recently-used idle container of fn (peek)."""
        h = self._idle_heaps.get(fn_id)
        while h:
            _, seq, c = h[0]
            if c.idle_seq == seq:
                return c
            heapq.heappop(h)            # stale: acquired or evicted
        return None

    def _remove(self, c: Container) -> None:
        """Drop an idle container from the pool entirely."""
        c.idle_seq = -1
        self._idle_by_fn[c.fn_id] -= 1
        self._n_idle -= 1
        self._count_by_fn[c.fn_id] -= 1
        self._total -= 1
        self._live.pop(c, None)

    def _evict_lru(self) -> bool:
        h = self._lru_heap
        while h:
            _, _, seq, c = heapq.heappop(h)
            if c.idle_seq != seq:
                continue                # stale: re-acquired or gone
            self._remove(c)
            self.evictions += 1
            return True
        return False

    # -- lifecycle ----------------------------------------------------------
    def acquire(self, fn_id: str, now: float,
                device_resident: bool) -> Tuple[Container, str]:
        """Returns (container, start_type)."""
        h = self._idle_heaps.get(fn_id)     # _idle peek + pop, one lookup
        while h:
            _, seq, c = h[0]
            if c.idle_seq != seq:
                heapq.heappop(h)            # stale: acquired or evicted
                continue
            heapq.heappop(h)                # the validated top
            c.idle_seq = -1             # lru-heap entry dies by validation
            self._idle_by_fn[fn_id] -= 1
            self._n_idle -= 1
            c.busy = True
            c.last_use = now
            if device_resident:
                self.warm_starts += 1
                return c, "warm"
            self.host_warm_starts += 1
            return c, "host_warm"
        # need a new container
        while self._total >= self.max_containers:
            if not self._evict_lru():
                break  # everything busy: exceed pool rather than deadlock
        c = Container(fn_id, created=now, last_use=now, busy=True)
        self._live[c] = None
        self._total += 1
        self._count_by_fn[fn_id] = self._count_by_fn.get(fn_id, 0) + 1
        self.cold_starts += 1
        return c, "cold"

    def release(self, c: Container, now: float) -> None:
        fn_id = c.fn_id
        c.busy = False
        c.last_use = now
        stamp = self._fn_stamp.get(fn_id)
        if stamp is None:
            stamp = self._fn_stamp[fn_id] = next(self._stamp)
        seq = next(self._seq)
        c.idle_seq = seq
        h = self._idle_heaps.get(fn_id)
        if h is None:
            h = self._idle_heaps[fn_id] = []
        heapq.heappush(h, (-now, seq, c))
        heapq.heappush(self._lru_heap, (now, stamp, seq, c))
        self._idle_by_fn[fn_id] = self._idle_by_fn.get(fn_id, 0) + 1
        n_idle = self._n_idle = self._n_idle + 1
        if len(self._lru_heap) > 64 + 4 * (n_idle if n_idle > 1 else 1):
            self._compact()

    def destroy(self, c: Container) -> None:
        """Fault plane: the container's process was killed (hung attempt
        watchdog-terminated). Unlike ``release`` it never returns to the
        idle lists — the next start of this fn pays a cold init. Valid on
        a busy container (the common case: it was mid-execution); an
        idle one is removed through the normal path."""
        self.destroyed += 1
        if c.idle_seq >= 0:
            self._remove(c)
            return
        self._count_by_fn[c.fn_id] -= 1
        self._total -= 1
        self._live.pop(c, None)

    def evict_fn(self, fn_id: str) -> None:
        """Drop idle containers of an inactive function (LRU keep-alive).
        Busy containers stay, exactly as in the reference."""
        h = self._idle_heaps.pop(fn_id, None)
        if h:
            for _, seq, c in h:
                if c.idle_seq == seq:
                    self._remove(c)
        # the reference pops the dict key, so a later release re-inserts
        # the fn at the END of the iteration order: drop the stamp too
        self._fn_stamp.pop(fn_id, None)
        self._idle_by_fn.pop(fn_id, None)

    def _compact(self) -> None:
        self._lru_heap = [e for e in self._lru_heap
                          if e[3].idle_seq == e[2]]
        heapq.heapify(self._lru_heap)
        for fn in list(self._idle_heaps):
            h = [e for e in self._idle_heaps[fn] if e[2].idle_seq == e[1]]
            if h:
                heapq.heapify(h)
                self._idle_heaps[fn] = h
            else:
                del self._idle_heaps[fn]

    @property
    def cold_hit_pct(self) -> float:
        total = self.cold_starts + self.warm_starts + self.host_warm_starts
        return 100.0 * self.cold_starts / total if total else 0.0


class StagingPool:
    """Bounded pinned-host staging for H2D transfers (repro.datapath).

    DMA engines read from pinned (page-locked) host memory; a transfer
    holds a staging reservation for its full in-flight span and releases
    it at completion or cancellation. The bound backpressures the data
    plane: transfers that do not fit wait (FIFO within their priority
    class, see ``DeviceDataPath``) instead of oversubscribing host
    memory.

    A transfer larger than the whole pool is admitted when the pool is
    empty — it streams through the staging buffers in chunks — so one
    oversized model cannot deadlock the link."""

    __slots__ = ("capacity", "used", "peak", "rejections")

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self.used = 0
        self.peak = 0           # high-water mark
        self.rejections = 0     # reserve() calls that had to wait

    def reserve(self, nbytes: int) -> bool:
        if self.used + nbytes > self.capacity and self.used > 0:
            self.rejections += 1
            return False
        self.used += nbytes
        if self.used > self.peak:
            self.peak = self.used
        return True

    def release(self, nbytes: int) -> None:
        self.used -= nbytes
