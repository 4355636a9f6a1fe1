"""Peer-to-peer transfer fabric: per-device-pair interconnect links.

A cold start on device B whose weights are already resident in device
A's HBM can stream them over the A->B interconnect (NVLink-class,
``ServerConfig.p2p_bw``) instead of re-reading host DRAM through B's
PCIe link. The fabric models one ``SharedLink`` per *directed* device
pair (full-duplex interconnect; each direction is an independent
contended resource), created lazily — an idle pair costs nothing.

Ownership: every transfer on link (a -> b) belongs to device b's
``DeviceDataPath`` (it lives in that datapath's ``transfers`` dict and
is popped by its ``advance``), so completion routing never has to
disambiguate directions.

Source tracking: migrations read the source region through the
``DeviceMemoryManager``'s normal residency surface — the source region
stays *evictable* (same convention as ``begin_prefetch``: anticipation
never pins memory). The fabric keeps a sourcing index so that when a
source region is evicted (pressure, or ``invalidate_device`` on a
device fault) every migration streaming from it falls back to the
destination's host link, restarting from byte zero with its dispatch
waiters preserved (the ``abort``-with-retry convention)."""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from repro_torch.datapath.link import SharedLink, Transfer


class Fabric:
    """All-to-all peer interconnect for one control plane's devices."""

    # link class is an attribute so the differential tests can swap in
    # ReferenceSharedLink fabric-wide
    link_cls = SharedLink

    def __init__(self, p2p_bw: float):
        self.bw = float(p2p_bw)
        self.links: Dict[Tuple[int, int], SharedLink] = {}  # (src, dst)
        # sourcing index: src dev -> fn_id -> destination datapaths with
        # an in-flight migration reading that source region
        self._sources: Dict[int, Dict[str, Set]] = {}
        # stats
        self.migrations_started = 0
        self.migrations_completed = 0
        self.migrations_fallback = 0
        self.bytes_migrated = 0

    def link(self, src: int, dst: int) -> SharedLink:
        """The directed src->dst interconnect link (lazily created)."""
        key = (src, dst)
        l = self.links.get(key)
        if l is None:
            l = self.link_cls(self.bw)
            self.links[key] = l
        return l

    # -- sourcing index ----------------------------------------------------
    def register(self, src: int, fn_id: str, dst_dp) -> None:
        self._sources.setdefault(src, {}).setdefault(fn_id,
                                                     set()).add(dst_dp)
        self.migrations_started += 1

    def unregister(self, src: int, fn_id: str, dst_dp) -> None:
        by_fn = self._sources.get(src)
        if by_fn is None:
            return
        dsts = by_fn.get(fn_id)
        if dsts is None:
            return
        dsts.discard(dst_dp)
        if not dsts:
            del by_fn[fn_id]

    def on_source_evicted(self, src: int, fn_id: str) -> List:
        """A source region left its HBM mid-migration: detach and return
        every destination datapath that was streaming from it (the
        control plane's evict listener calls ``peer_source_lost`` on
        each, converting the migration to a host transfer)."""
        by_fn = self._sources.get(src)
        if by_fn is None:
            return []
        dsts = by_fn.pop(fn_id, None)
        return list(dsts) if dsts else []

    def sourcing_from(self, src: int) -> List[Tuple[str, object]]:
        """Every (fn_id, destination datapath) migration currently
        reading device ``src``'s HBM (device-fault teardown sweep)."""
        by_fn = self._sources.get(src)
        if not by_fn:
            return []
        return [(fn, dp) for fn, dsts in by_fn.items() for dp in dsts]

    # -- conservation surface (tests / chaos drain checks) -----------------
    def in_flight(self) -> List[Transfer]:
        return [t for l in self.links.values() for t in l.active]

    def backlog_bytes(self, src: int, dst: int) -> float:
        """Outstanding demand bytes on the src->dst direction (placement
        bid input); 0 when the pair has never been used."""
        l = self.links.get((src, dst))
        return l.backlog_bytes() if l is not None else 0.0
