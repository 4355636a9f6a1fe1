"""The traced slice: the card's activity from ``torch.profiler`` (CUDA
activity only, kept in memory, never exported) over the window's last
TRACE_S seconds, summed into what the per-layer metrics and the
breakdown read.

Device time is every kernel, copy and set the profiler records; the
busy time is the union of their intervals inside the slice. An idle gap
is named after the harness's host range (``execute``, ``prefill``,
``decode``, ``upload``) that holds its midpoint, the innermost if several
do, or ``none``; the profiler's device timestamps and the host ranges are
both on the wall clock in nanoseconds.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

TRACE_S = 12.0
TOP = 10
BUCKET_NS = 5_000_000
NAME_CHARS = 160


class Slice:
    """The profiler over the window's last TRACE_S seconds. It is prepared
    in the set-up (the profiler takes seconds to start), starts recording
    with ``start`` (a millisecond) and stops with ``stop`` when the window
    closes, all on the generator's thread, so no arrival waits on it; the
    events are summed after the window (``summarize``)."""

    def __init__(self, spans):
        self.spans = spans
        self.t0 = self.t1 = 0
        from torch.profiler import ProfilerActivity, profile, schedule
        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1,
                                              repeat=1))
        self.prof.start()

    def start(self) -> None:
        self.prof.step()
        self.t0 = time.time_ns()
        self.spans.active = True

    def stop(self) -> None:
        self.spans.active = False
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()

    def summarize(self) -> Dict:
        return summarize(
            [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in self.prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and not e.is_user_annotation()],
            self.spans.ranges, self.t0, self.t1)


def summarize(dev: List[tuple], ranges: List[tuple], t0: int, t1: int
              ) -> Dict:
    """``dev``: (name, start ns, end ns) of device operations; ``ranges``:
    (name, start ns, end ns) host ranges; the slice is [t0, t1)."""
    by_name: Dict[str, float] = {}
    iv = []
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        s, e = max(s, t0), min(e, t1)
        if e > s:
            iv.append((s, e))
    iv.sort()
    busy, gaps, end = 0, [], t0
    for s, e in iv:
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if t1 > end:
        gaps.append((end, t1))
    named: Dict[str, float] = {}
    index: Dict[int, List[tuple]] = {}
    for r in ranges:
        for b in range(r[1] // BUCKET_NS, r[2] // BUCKET_NS + 1):
            index.setdefault(b, []).append(r)
    for s, e in gaps:
        mid, best = (s + e) // 2, None
        for name, rs, re_ in index.get(mid // BUCKET_NS, ()):
            if rs <= mid < re_ and (best is None or re_ - rs < best[1]):
                best = (name, re_ - rs)
        key = best[0] if best else "none"
        named[key] = named.get(key, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9,
            "op_s": by_name,
            "device_ops": [[n[:NAME_CHARS], s] for n, s in top],
            "idle_gaps": sorted(([n, s] for n, s in named.items()),
                                key=lambda kv: -kv[1])[:TOP]}
