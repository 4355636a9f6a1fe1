"""Reference device layer: the pre-index linear-scan implementations.

``ReferenceDeviceMemoryManager`` and ``ReferenceWarmPool`` are the seed's
``memory/manager.py`` / ``memory/pool.py`` hot paths kept verbatim — the
per-miss ``sorted(regions)`` LRU scan, the flatten-everything pool
eviction, the O(pool) ``count`` — as the executable specification for the
indexed structures that replaced them (same convention as
``repro.core.reference`` for the scheduler core).

``tests/test_memory_equivalence.py`` proves the indexed layer reproduces
these implementations bit-for-bit: eviction order (including the
stable-sort tie-breaks on region/container creation order and the
second-pass resident sweep that re-walks the pre-eviction snapshot),
start-type classification, admission decisions and byte accounting.
``benchmarks/scale.py --device-compare`` uses them as the perf baseline
(select with ``ServerConfig(device_layer="reference")``).

Do not "fix" or optimize this file: its value is bug-for-bug fidelity to
the seed. Behavioral changes belong in the indexed twin plus a
differential test here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.memory.manager import (GB, MADVISE_DISPATCH_OVERHEAD,
                                  ONDEMAND_PENALTY, THRASH_PENALTY, Region)
from repro_torch.memory.pool import Container


class ReferenceDeviceMemoryManager:
    def __init__(self, capacity_bytes: int = 16 * GB,
                 h2d_bw: float = 100 * GB,  # bytes/s DMA
                 policy: str = "prefetch_swap"):
        assert policy in ("ondemand", "madvise", "prefetch", "prefetch_swap")
        self.capacity = capacity_bytes
        self.h2d_bw = h2d_bw
        self.policy = policy
        self.regions: Dict[str, Region] = {}
        # notified with fn_id whenever a region is swapped out; the
        # wall-clock executor mirrors these onto real endpoints
        self.evict_listeners: List = []
        # accounting
        self.bytes_uploaded = 0
        self.bytes_evicted = 0
        self.prefetch_count = 0
        self._used = 0          # running sum of resident region sizes

    # -- bookkeeping ------------------------------------------------------
    def region(self, fn_id: str, size: int) -> Region:
        r = self.regions.get(fn_id)
        if r is None:
            r = Region(fn_id, size)
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

    @property
    def used(self) -> int:
        return self._used

    def free_bytes(self) -> int:
        return self.capacity - self._used

    # -- eviction -----------------------------------------------------------
    def _evict_lru(self, need: int, now: float,
                   protect: Tuple[str, ...] = ()) -> bool:
        """Free >= need bytes by swapping out evictable (then any idle)
        resident regions in LRU order. Swap-out is async (off the critical
        path), so capacity is released immediately."""
        if self.free_bytes() >= need:
            return True
        pools = (
            [r for r in self.regions.values()
             if r.resident and r.evictable and r.fn_id not in protect],
            [r for r in self.regions.values()
             if r.resident and r.fn_id not in protect],
        )
        for pool in pools:
            for r in sorted(pool, key=lambda r: r.last_use):
                self._set_resident(r, False)
                r.upload_eta = -1.0
                self.bytes_evicted += r.size
                self._notify_evict(r.fn_id)
                if self.free_bytes() >= need:
                    return True
        return self.free_bytes() >= need

    def _notify_evict(self, fn_id: str) -> None:
        for cb in self.evict_listeners:
            cb(fn_id)

    # -- scheduler hooks ------------------------------------------------------
    def on_queue_active(self, fn_id: str, size: int, now: float) -> None:
        """Anticipatory prefetch when a queue becomes active (§4.3)."""
        r = self.region(fn_id, size)
        r.evictable = False
        if self.policy not in ("prefetch", "prefetch_swap"):
            return
        if r.resident or r.upload_eta > now:
            return
        if not self._evict_lru(r.size, now, protect=(fn_id,)):
            return  # no space: upload will happen at dispatch
        r.upload_eta = now + r.size / self.h2d_bw
        self._set_resident(r, True)   # reserved now, usable at upload_eta
        self.prefetch_count += 1
        self.bytes_uploaded += r.size

    def on_queue_idle(self, fn_id: str, now: float) -> None:
        """Throttled/Inactive: mark for (async) LRU eviction."""
        r = self.regions.get(fn_id)
        if r is None:
            return
        r.evictable = True
        if self.policy == "prefetch_swap":
            # async swap-out; capacity released immediately, write-back
            # is off the critical path
            if r.resident and r.upload_eta <= now:
                self._set_resident(r, False)
                self.bytes_evicted += r.size
                self._notify_evict(r.fn_id)

    # -- dispatch-time ---------------------------------------------------------
    def admit(self, fn_id: str, size: int, running, now: float) -> bool:
        """Memory admission control (§4.4): dispatch only if the working
        sets of running functions + this one fit physical memory.
        ``running`` is a dict fn_id -> bytes (the seed interface) or a
        pre-summed byte count."""
        reserved = (running if isinstance(running, (int, float))
                    else sum(running.values())) + size
        return reserved <= self.capacity

    def acquire(self, fn_id: str, size: int, now: float
                ) -> Tuple[float, float]:
        """Make fn resident for execution. Returns (ready_time,
        exec_multiplier): ready_time is when data is on device; the
        multiplier stretches execution for paging-style policies."""
        r = self.region(fn_id, size)
        r.evictable = False
        r.last_use = now
        mult = 1.0
        if self.policy in ("ondemand", "madvise"):
            # pages migrate on first touch during execution
            if not r.resident:
                self._evict_lru(r.size, now, protect=(fn_id,))
                self._set_resident(r, True)
                self.bytes_uploaded += r.size
                mult_bytes = r.size / self.h2d_bw
                # stretch execution instead of upfront wait
                return (now + (MADVISE_DISPATCH_OVERHEAD
                               if self.policy == "madvise" else 0.0),
                        1.0 + ONDEMAND_PENALTY * mult_bytes)
            if self.policy == "madvise":
                return now + MADVISE_DISPATCH_OVERHEAD, 1.0
            return now, 1.0
        # prefetch / prefetch_swap
        if r.resident:
            ready = max(now, r.upload_eta)
            return ready, mult
        # miss: synchronous upload on the critical path
        needed_eviction = self.free_bytes() < r.size
        self._evict_lru(r.size, now, protect=(fn_id,))
        if self.policy == "prefetch" and needed_eviction:
            # no proactive swap-out: reclaim happens lazily during
            # execution (UVM-style page-out on demand) -> exec stretch
            mult = THRASH_PENALTY
        self._set_resident(r, True)
        r.upload_eta = now + r.size / self.h2d_bw
        self.bytes_uploaded += r.size
        return r.upload_eta, mult

    def is_resident(self, fn_id: str, now: float) -> bool:
        r = self.regions.get(fn_id)
        return bool(r and r.resident and r.upload_eta <= now)


class ReferenceWarmPool:
    def __init__(self, max_containers: int = 32):
        self.max_containers = max_containers
        self.containers: List[Container] = []
        # per-function index of idle containers: keeps acquire O(idle
        # copies of fn) instead of O(pool)
        self._idle_by_fn: Dict[str, List[Container]] = {}
        # stats
        self.cold_starts = 0
        self.warm_starts = 0
        self.host_warm_starts = 0
        self.evictions = 0

    def _idle(self, fn_id: str) -> Optional[Container]:
        best = None
        for c in self._idle_by_fn.get(fn_id, ()):
            if best is None or c.last_use > best.last_use:
                best = c
        return best

    def _unindex(self, c: Container) -> None:
        lst = self._idle_by_fn.get(c.fn_id)
        if lst is not None and c in lst:
            lst.remove(c)

    def count(self, fn_id: Optional[str] = None) -> int:
        if fn_id is None:
            return len(self.containers)
        return sum(1 for c in self.containers if c.fn_id == fn_id)

    def _evict_lru(self) -> bool:
        idle = [c for lst in self._idle_by_fn.values() for c in lst]
        if not idle:
            return False
        victim = min(idle, key=lambda c: c.last_use)
        self._unindex(victim)
        self.containers.remove(victim)
        self.evictions += 1
        return True

    def acquire(self, fn_id: str, now: float,
                device_resident: bool) -> Tuple[Container, str]:
        """Returns (container, start_type)."""
        c = self._idle(fn_id)
        if c is not None:
            self._unindex(c)
            c.busy = True
            c.last_use = now
            if device_resident:
                self.warm_starts += 1
                return c, "warm"
            self.host_warm_starts += 1
            return c, "host_warm"
        # need a new container
        while len(self.containers) >= self.max_containers:
            if not self._evict_lru():
                break  # everything busy: exceed pool rather than deadlock
        c = Container(fn_id, created=now, last_use=now, busy=True)
        self.containers.append(c)
        self.cold_starts += 1
        return c, "cold"

    def release(self, c: Container, now: float) -> None:
        c.busy = False
        c.last_use = now
        self._idle_by_fn.setdefault(c.fn_id, []).append(c)

    def evict_fn(self, fn_id: str) -> None:
        """Drop idle containers of an inactive function (LRU keep-alive)."""
        self._idle_by_fn.pop(fn_id, None)
        self.containers = [
            c for c in self.containers if c.busy or c.fn_id != fn_id]

    @property
    def cold_hit_pct(self) -> float:
        total = self.cold_starts + self.warm_starts + self.host_warm_starts
        return 100.0 * self.cold_starts / total if total else 0.0
