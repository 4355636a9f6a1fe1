"""Per-device cold-start data plane: links + staging + memory wiring.

``DeviceDataPath`` owns one device's host->HBM ``SharedLink`` and
``StagingPool``, plus (when a ``Fabric`` is wired) the *inbound*
directed peer links streaming weights out of other devices' HBM, and
keeps the ``DeviceMemoryManager``'s view truthful: a region's
``upload_eta`` always reflects the owning link's *current* plan (inf
while the transfer is paused behind demand traffic or queued on
staging), and is finalized by ``finish_upload`` when the bytes actually
land.

Lifecycle of a transfer:

    request(kind="prefetch")  — anticipatory upload (queue activation or
                                the control plane's drain-prefetch pass)
    request(kind="demand") /
    mark_demand()             — a dispatch is waiting on the bytes; the
                                transfer preempts background prefetches
    request(src=a)            — peer migration: the bytes stream from
                                device ``a``'s HBM over the fabric link
                                (no pinned-host staging on that path)
    advance(now)              — a TRANSFER event fired: pop chunk
                                milestones + completions, release
                                staging, notify the memory manager, fire
                                dispatch waiters, start staging-blocked
                                transfers
    cancel(fn_id)             — the flow went Inactive or its region was
                                evicted before dispatch; only background
                                prefetches (no waiters) are cancellable
    peer_source_lost(fn_id)   — the *source* region of an in-flight
                                migration was evicted: fall back to the
                                host link, restarting from byte zero
                                with waiters preserved (the abort-with-
                                retry convention)

The control plane refreshes ``now`` at every event (``datapath_tick``)
so evict-listener cancellations — which arrive without a timestamp —
integrate link progress at the right instant.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.datapath.link import INF, _EPS_BYTES, SharedLink, Transfer
from repro_torch.memory.pool import StagingPool


class DeviceDataPath:
    def __init__(self, dev_id: int, h2d_bw: float, staging_bytes: int,
                 mem, fabric=None) -> None:
        self.dev_id = dev_id
        self.link = SharedLink(h2d_bw)
        self.staging = StagingPool(staging_bytes)
        self.mem = mem
        self.fabric = fabric
        # inbound directed peer links (src dev -> SharedLink); every
        # transfer on them belongs to THIS device's ``transfers``
        self._in_links: Dict[int, SharedLink] = {}
        self.transfers: Dict[str, Transfer] = {}   # active + queued
        self.waiting: List[Transfer] = []          # staging-blocked FIFO
        self.now = 0.0
        self.n_prefetch = 0        # in-flight (active or queued) prefetches
        # stats
        self.demand_transfers = 0
        self.prefetches_started = 0
        self.prefetches_upgraded = 0
        self.prefetches_cancelled = 0
        self.transfers_completed = 0
        self.bytes_transferred = 0
        self.transfer_aborts = 0
        self.migrations_in = 0         # peer transfers started here
        self.migrations_completed = 0
        self.migrations_fallback = 0   # source evicted -> host restart

    # -- entry points ------------------------------------------------------
    def request(self, fn_id: str, nbytes: int, now: float,
                kind: str = "demand", prio: float = 0.0,
                src: Optional[int] = None) -> float:
        """Start (or join) a transfer of fn's weights; returns the
        planned completion eta (inf while paused or staging-blocked).
        This is the memory manager's ``uploader`` hook. ``prio`` orders
        service within the prefetch class (lower = sooner). ``src``
        routes the bytes over the fabric link from a peer device's HBM
        instead of host DRAM (peer migrations bypass the pinned-host
        staging pool — the bytes never touch the host)."""
        self.now = now
        t = self.transfers.get(fn_id)
        if t is not None:
            if kind == "demand" and t.kind != "demand":
                self.mark_demand(fn_id, now)
            return t.eta
        t = Transfer(fn_id, nbytes, kind, prio, src=src)
        self.transfers[fn_id] = t
        if kind == "demand":
            self.demand_transfers += 1
        else:
            self.prefetches_started += 1
            self.n_prefetch += 1
        if src is not None:
            self.migrations_in += 1
            link = self._in_links.get(src)
            if link is None:
                link = self.fabric.link(src, self.dev_id)
                self._in_links[src] = link
            self.fabric.register(src, fn_id, self)
            link.add(t, now)
            self._sync_etas()
            return t.eta
        if self.staging.reserve(t.nbytes):
            self.link.add(t, now)
            self._sync_etas()
        else:
            t.queued = True
            w = self.waiting
            if kind == "demand":
                # ahead of queued prefetches, behind earlier demand
                i = 0
                while i < len(w) and w[i].kind == "demand":
                    i += 1
                w.insert(i, t)
                self._preempt_for_demand(now)
            else:
                # behind demand and better-prio prefetches (FIFO on ties)
                i = len(w)
                while i > 0 and w[i - 1].kind != "demand" \
                        and w[i - 1].prio > prio:
                    i -= 1
                w.insert(i, t)
        return t.eta

    def _link_of(self, t: Transfer) -> SharedLink:
        """The link an active transfer rides: an inbound fabric link for
        a peer migration, the device's own H2D link otherwise."""
        if t.src is not None:
            return self._in_links[t.src]
        return self.link

    def mark_demand(self, fn_id: str, now: float) -> None:
        """Upgrade a prefetch to the demand class: a dispatched
        invocation now waits on it."""
        t = self.transfers.get(fn_id)
        if t is None or t.kind == "demand":
            return
        self.now = now
        self.n_prefetch -= 1
        self.prefetches_upgraded += 1
        if t.queued:
            t.kind = "demand"
            w = self.waiting
            w.remove(t)
            i = 0
            while i < len(w) and w[i].kind == "demand":
                i += 1
            w.insert(i, t)
            self._preempt_for_demand(now)
        else:
            self._link_of(t).mark_demand(t, now)
            self._sync_etas()

    def await_first_chunk(self, fn_id: str, chunk_bytes: int, cb,
                          now: float) -> bool:
        """Chunked layer streaming: fire ``cb(t_done)`` once the first
        ``chunk_bytes`` of fn's weights have landed, leaving the
        residual streaming in its current class on the same link.
        Returns False when the chunk is already on device (caller
        proceeds immediately). A transfer smaller than one chunk waits
        for full completion (no split possible)."""
        t = self.transfers.get(fn_id)
        if t is None:
            return False
        if t.nbytes <= chunk_bytes:
            t.waiters.append(cb)
            return True
        thresh = float(t.nbytes - chunk_bytes)
        if t.remaining <= thresh + _EPS_BYTES:
            return False           # first chunk already landed
        t.chunk_waiters.append(cb)
        if t.chunk_rem is None:
            if t.queued:
                t.chunk_rem = thresh   # counted when it enters the link
            else:
                self._link_of(t).arm_milestone(t, thresh, now)
                self._sync_etas()
        return True

    def cancel(self, fn_id: str, now: float) -> bool:
        """Abort a background prefetch (flow went Inactive). Demand
        transfers and transfers with dispatch waiters are not
        cancellable — an invocation depends on them."""
        t = self.transfers.get(fn_id)
        if t is None or t.kind == "demand" or t.waiters or t.chunk_waiters:
            return False
        del self.transfers[fn_id]
        self.n_prefetch -= 1
        self.prefetches_cancelled += 1
        if t.queued:
            self.waiting.remove(t)
        elif t.src is not None:
            self._in_links[t.src].remove(t, now)
            self.fabric.unregister(t.src, fn_id, self)
            self._sync_etas()
        else:
            self.link.remove(t, now)
            self.staging.release(t.nbytes)
            self._start_waiting(now)
            self._sync_etas()
        return True

    # -- peer migration ------------------------------------------------------
    def peer_source_lost(self, fn_id: str, now: float) -> bool:
        """The source region of an in-flight migration was evicted from
        its HBM (pressure, Inactive drop, or device fault): the peer
        stream has nothing left to read. Fall back to the host link —
        restart from byte zero (host DRAM holds the canonical copy),
        dispatch waiters and chunk milestones preserved, staging
        reserved or queued exactly like an ``abort`` retry. The
        destination region's accounting is untouched: it was charged
        through the normal admit path and simply completes later."""
        t = self.transfers.get(fn_id)
        if t is None or t.src is None:
            return False
        self.now = now
        self._in_links[t.src].remove(t, now)
        t.src = None
        self.migrations_fallback += 1
        if self.fabric is not None:
            self.fabric.migrations_fallback += 1
        t.remaining = float(t.nbytes)      # restart from byte zero
        t.eta = INF
        if self.staging.reserve(t.nbytes):
            t.queued = False
            self.link.add(t, now)
        else:
            t.queued = True
            self._queue_waiting(t)
            self.mem.set_upload_eta(fn_id, INF)
        self._start_waiting(now)
        self._sync_etas()
        return True

    def _queue_waiting(self, t: Transfer) -> None:
        """Insert a staging-blocked transfer into ``waiting`` with the
        class/prio placement ``request`` uses."""
        w = self.waiting
        if t.kind == "demand":
            i = 0
            while i < len(w) and w[i].kind == "demand":
                i += 1
        else:
            i = len(w)
            while i > 0 and w[i - 1].kind != "demand" \
                    and w[i - 1].prio > t.prio:
                i -= 1
        w.insert(i, t)

    # -- fault plane --------------------------------------------------------
    def abort(self, fn_id: str, now: float, retry: bool = True) -> bool:
        """Fault injection: the in-flight DMA for ``fn_id`` was killed.

        With ``retry`` (recovery on) the transfer restarts from byte
        zero — the *same* ``Transfer`` object, dispatch waiters
        preserved — re-entering its link (a peer migration restarts on
        the same fabric direction: the source region is still resident;
        a host transfer re-reserves staging or queues). With recovery
        off it is dropped outright: the region is released and waiters
        fire with ``None`` so the executor fails the dependent
        attempt."""
        t = self.transfers.get(fn_id)
        if t is None:
            return False
        self.now = now
        self.transfer_aborts += 1
        peer = t.src is not None
        if t.queued:
            self.waiting.remove(t)
        elif peer:
            self._in_links[t.src].remove(t, now)
        else:
            self.link.remove(t, now)
            self.staging.release(t.nbytes)
        if retry:
            t.remaining = float(t.nbytes)      # restart from byte zero
            t.eta = INF
            if peer:
                t.queued = False
                self._in_links[t.src].add(t, now)
            elif self.staging.reserve(t.nbytes):
                t.queued = False
                self.link.add(t, now)
            else:
                t.queued = True
                w = self.waiting               # same placement as request()
                if t.kind == "demand":
                    i = 0
                    while i < len(w) and w[i].kind == "demand":
                        i += 1
                else:
                    i = len(w)
                    while i > 0 and w[i - 1].kind != "demand" \
                            and w[i - 1].prio > t.prio:
                        i -= 1
                w.insert(i, t)
                self.mem.set_upload_eta(fn_id, INF)
            self._start_waiting(now)
            self._sync_etas()
            return True
        del self.transfers[fn_id]
        if peer:
            self.fabric.unregister(t.src, fn_id, self)
        if t.kind != "demand":
            self.n_prefetch -= 1
            self.prefetches_cancelled += 1
        self.mem.drop_region(fn_id)
        self._start_waiting(now)
        self._sync_etas()
        for cb in t.chunk_waiters:
            cb(None)
        for cb in t.waiters:
            cb(None)
        return True

    def abort_all(self, now: float) -> int:
        """Device fault: tear down the whole per-device data plane.
        Every transfer — active, staging-blocked, or streaming in over a
        peer link — is dropped without firing waiters (the control plane
        fails the doomed invocations itself) and staging reservations
        are returned. Regions are NOT touched here: ``fail_device``
        follows up with the memory manager's ``invalidate_device``
        (whose evict listeners also fall back any migration *sourced*
        from this device)."""
        self.now = now
        n = len(self.transfers)
        if n == 0:
            return 0
        self.transfer_aborts += n
        for t in list(self.link.active):
            self.link.remove(t, now)
            self.staging.release(t.nbytes)
        for src, link in self._in_links.items():
            for t in list(link.active):
                link.remove(t, now)
                self.fabric.unregister(src, t.fn_id, self)
        self.waiting.clear()       # queued transfers hold no reservation
        self.transfers.clear()
        self.n_prefetch = 0
        return n

    def on_region_evicted(self, fn_id: str) -> None:
        """Memory-manager evict listener: a prefetch-in-flight region
        was reclaimed under pressure — abort its transfer. (Regions of
        dispatched transfers have waiters, so ``cancel`` refuses and the
        upload keeps accounting/reality reconcilable at completion.)"""
        self.cancel(fn_id, self.now)

    # -- event-loop surface -------------------------------------------------
    def next_eta(self) -> Optional[float]:
        best = self.link.next_eta()
        if self._in_links:
            for link in self._in_links.values():
                e = link.next_eta()
                if e is not None and (best is None or e < best):
                    best = e
        return best

    def advance(self, now: float) -> List[Transfer]:
        """Realize every chunk milestone and transfer completed by
        ``now``."""
        self.now = now
        if self._in_links:
            hits = self.link.pop_milestones(now)
            done = self.link.pop_completed(now)
            for link in self._in_links.values():
                hits += link.pop_milestones(now)
                done += link.pop_completed(now)
        else:
            hits = self.link.pop_milestones(now)
            done = self.link.pop_completed(now)
        if not (done or hits):
            return done
        mem = self.mem
        for t in done:
            del self.transfers[t.fn_id]
            if t.kind != "demand":
                self.n_prefetch -= 1
            if t.src is not None:
                self.fabric.unregister(t.src, t.fn_id, self)
                self.fabric.migrations_completed += 1
                self.fabric.bytes_migrated += t.nbytes
                self.migrations_completed += 1
            else:
                self.staging.release(t.nbytes)
            self.transfers_completed += 1
            self.bytes_transferred += t.nbytes
            mem.finish_upload(t.fn_id, now)
        if done:
            self._start_waiting(now)
        self._sync_etas()
        for t in hits:
            if t.chunk_waiters:
                waiters, t.chunk_waiters = t.chunk_waiters, []
                for cb in waiters:
                    cb(now)
        for t in done:
            if t.chunk_waiters:     # milestone and completion coincided
                waiters, t.chunk_waiters = t.chunk_waiters, []
                for cb in waiters:
                    cb(now)
            for cb in t.waiters:
                cb(now)
        return done

    # -- internals ----------------------------------------------------------
    def _start_waiting(self, now: float) -> None:
        """Move staging-blocked transfers onto the link, demand class
        first, stopping at the first that still does not fit (strict
        FIFO within class: small transfers cannot starve a big one)."""
        w = self.waiting
        while w:
            t = w[0]
            if not self.staging.reserve(t.nbytes):
                break
            w.pop(0)
            t.queued = False
            self.link.add(t, now)

    def _preempt_for_demand(self, now: float) -> None:
        """A dispatched invocation's transfer is blocked on the staging
        pool: bump paused prefetches off their staging buffers (worst
        dispatch priority first) until the demand head fits. A bumped
        prefetch keeps the bytes already moved and re-queues behind the
        demand class; the staging pool itself stays a hard bound."""
        w = self.waiting
        while w and w[0].kind == "demand":
            head = w[0]
            if self.staging.reserve(head.nbytes):
                w.pop(0)
                head.queued = False
                self.link.add(head, now)
                self._sync_etas()
                continue
            paused = [t for t in self.link.active if t.kind != "demand"]
            if not paused:
                break       # nothing left to bump; wait for completions
            v = max(paused, key=lambda t: t.prio)
            self.link.remove(v, now)
            self.staging.release(v.nbytes)
            self.mem.set_upload_eta(v.fn_id, INF)
            v.queued = True
            i = len(w)
            while i > 0 and w[i - 1].kind != "demand" \
                    and w[i - 1].prio > v.prio:
                i -= 1
            w.insert(i, v)

    def _sync_etas(self) -> None:
        """Mirror the links' re-planned etas into the memory manager so
        ``is_resident`` never claims a mid-flight region usable. Covers
        the H2D link and every inbound peer link (staging-queued
        transfers are pinned to inf separately at queue time)."""
        set_eta = self.mem.set_upload_eta
        for t in self.transfers.values():
            if not t.queued:
                set_eta(t.fn_id, t.eta)
