"""Spans of the serving path, kept in memory; off unless switched on.

``TorchEndpoint`` records where its time goes: the wait for its lock
(``lock``), the inputs (``inputs``), the prefill (``prefill``), each
decode step (``decode``), the host's wait for the device (``sync``), an
upload of the weights (``upload``, with its bytes and its own ``sync``
inside it), a cold start (``compile``) and, as an instant, an eviction
that released device memory (``evict``).

    from repro_torch.runtime import trace
    trace.enable()          # start recording, from an empty record
    ...                     # serve
    trace.disable()
    spans = trace.snapshot()["spans"]

Off, each site reads one module-level flag and returns: no clock is
read, nothing is allocated, no lock is taken. On, a span is one tuple
appended to a list by the thread that ran it (``list.append`` needs no
lock), stamped with ``time.monotonic_ns`` and the thread's CPU time over
the span (``time.thread_time_ns``): a span whose CPU time falls short of
its wall time slept (on a lock, the interpreter lock, a blocking wait);
a CUDA call that spins while it waits for the device counts as CPU time.

The executor and ``Invocation`` stamp ``time.monotonic``; ``torch.profiler``
stamps device activity on the wall clock (``time.time_ns``). ``enable``
and ``disable`` each take an anchor, one reading of both clocks, and
``snapshot`` gives every span on both, so spans, invocations and the
device trace share one time axis.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

# the two clocks' offset may drift this far while recording before
# ``snapshot`` says so
SKEW_WARN_NS = 1_000_000

_on = False
# (name, thread, start ns, end ns, thread CPU ns, fn_id, bytes); an
# instant has start == end
_spans: List[tuple] = []
_anchors: List[Tuple[int, int]] = []   # (monotonic ns, wall ns)


def _anchor() -> Tuple[int, int]:
    """The wall clock read between two monotonic reads, paired with
    their midpoint."""
    m0 = time.monotonic_ns()
    w = time.time_ns()
    m1 = time.monotonic_ns()
    return (m0 + m1) // 2, w


def enable() -> None:
    """Start recording, from an empty record."""
    global _on
    _spans.clear()
    _anchors[:] = [_anchor()]
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for ``snapshot``."""
    global _on
    _on = False
    if len(_anchors) == 1:
        _anchors.append(_anchor())


def begin() -> Optional[Tuple[int, int]]:
    """A span's start for ``end``; None while off."""
    if not _on:
        return None
    return time.monotonic_ns(), time.thread_time_ns()


def end(start: Optional[Tuple[int, int]], name: str,
        fn_id: Optional[str] = None, nbytes: int = 0) -> None:
    """Record the span begun at ``start``, if it began while recording
    (one that ends after ``disable`` is kept whole)."""
    if start is None:
        return
    _spans.append((name, threading.get_ident(), start[0],
                   time.monotonic_ns(), time.thread_time_ns() - start[1],
                   fn_id, nbytes))


def instant(name: str, fn_id: Optional[str] = None, nbytes: int = 0
            ) -> None:
    """Record a span of no length, now."""
    if not _on:
        return
    t = time.monotonic_ns()
    _spans.append((name, threading.get_ident(), t, t, 0, fn_id, nbytes))


def snapshot() -> Dict:
    """The spans begun since the last ``enable``, as plain data:
    ``spans``, each a dict of ``name``, ``thread``, ``fn``, ``bytes``,
    ``cpu_ns``, its start and end on the monotonic clock (``start_ns``,
    ``end_ns``) and on the wall clock (``start_wall_ns``,
    ``end_wall_ns``); ``anchors``, the two (monotonic ns, wall ns)
    readings (the second taken now if still recording); ``skew_ns``, how
    far the clocks' offset moved between them, over which the wall times
    are interpolated; and ``warning`` if that is more than 1 ms."""
    anchors = list(_anchors)
    if not anchors:
        return {"spans": [], "anchors": [], "skew_ns": 0}
    if len(anchors) == 1:
        anchors.append(_anchor())
    (m0, w0), (m1, w1) = anchors
    d0, skew = w0 - m0, (w1 - m1) - (w0 - m0)
    span_ns = max(m1 - m0, 1)

    def wall(m: int) -> int:
        return m + d0 + skew * (m - m0) // span_ns

    out: Dict = {
        "spans": [{"name": n, "thread": tid, "fn": fn, "bytes": nb,
                   "cpu_ns": cpu, "start_ns": s, "end_ns": e,
                   "start_wall_ns": wall(s), "end_wall_ns": wall(e)}
                  for n, tid, s, e, cpu, fn, nb in list(_spans)
                  if s >= m0],
        "anchors": [list(a) for a in anchors], "skew_ns": skew}
    if abs(skew) > SKEW_WARN_NS:
        out["warning"] = (f"the wall clock moved {skew / 1e6:.3f} ms "
                          f"against the monotonic clock while recording")
    return out
