"""Open-loop trace generation (paper §6 "Setup and Workloads") — streaming.

Two workload classes:
  - Zipfian: per-function exponential inter-arrival times, average rates
    zipf-distributed (parameter 1.5) across functions.
  - Azure-like: per-function mean IATs sampled from a heavy-tailed
    lognormal (the Azure FaaS trace is "extremely heavy-tailed"), with
    Weibull-shaped IATs (CV > 1, bursty). Different trace ids give
    different mixes/intensities, mirroring the paper's Table 3 samples.

Every workload is a *lazy stream*: each function owns an independent
inter-arrival-time generator (its own deterministically seeded RNG, so a
stream's prefix never depends on how much of any other stream was
consumed) and the per-function streams are merged through a k-way heap —
one pending event per function, O(F) memory at any duration, O(log F)
per emitted event. The historical ``zipf_trace``/``azure_trace`` list
APIs materialize the same streams for small traces; the simulator's
executor consumes streams directly so million-invocation replays never
hold an event list.

``repro.workloads.scenarios`` composes these primitives (plus
rate-modulated thinning) into named scenarios.
"""
from __future__ import annotations

import heapq
import math
import random
import zlib
from typing import (Callable, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, Tuple)

from repro_torch.workloads.spec import DEFAULT_MIX, FunctionSpec, function_copies


class TraceEvent(NamedTuple):
    """One arrival. A NamedTuple, not a frozen dataclass: the streaming
    generators allocate one per arrival on the simulator's hot path, and
    frozen-dataclass construction (object.__setattr__ per field) costs
    ~4x a tuple."""
    time: float
    fn_id: str


# -- stream primitives ------------------------------------------------------
def fn_rng(seed: int, fn_id: str) -> random.Random:
    """Deterministic per-function RNG: independent of consumption order
    of sibling streams (unlike the seed's one-shared-RNG generation) and
    stable across processes (crc32, not the salted builtin hash)."""
    return random.Random(((seed + 1) << 32) ^ zlib.crc32(fn_id.encode()))


def iat_stream(fn_id: str, draw_iat: Callable[[float], float],
               duration: float) -> Iterator[TraceEvent]:
    """Renewal arrival process: ``draw_iat(t)`` returns the next gap."""
    t = 0.0
    while True:
        t += draw_iat(t)
        if t >= duration:
            return
        yield TraceEvent(t, fn_id)


def thinned_poisson_stream(fn_id: str, rate_fn: Callable[[float], float],
                           rate_max: float, duration: float,
                           rng: random.Random) -> Iterator[TraceEvent]:
    """Non-homogeneous Poisson process by thinning: candidates at the
    envelope rate, accepted with probability rate(t)/rate_max. Drives the
    rate-modulated scenarios (flash crowds, diurnal cycles)."""
    t = 0.0
    while True:
        t += rng.expovariate(rate_max)
        if t >= duration:
            return
        if rng.random() * rate_max < rate_fn(t):
            yield TraceEvent(t, fn_id)


def merge_streams(streams: Iterable[Iterator[TraceEvent]]
                  ) -> Iterator[TraceEvent]:
    """K-way merge of time-ordered event streams: one pending event per
    stream, constant memory at any trace length."""
    heap: List[Tuple[float, int, TraceEvent, Iterator[TraceEvent]]] = []
    for i, s in enumerate(streams):
        ev = next(s, None)
        if ev is not None:
            heap.append((ev.time, i, ev, s))
    heapq.heapify(heap)
    while heap:
        _, i, ev, s = heap[0]
        yield ev
        nxt = next(s, None)
        if nxt is None:
            heapq.heappop(heap)
        else:
            heapq.heapreplace(heap, (nxt.time, i, nxt, s))


# -- workload families ------------------------------------------------------
def zipf_rates(fns: Dict[str, FunctionSpec], total_rps: float,
               zipf_param: float = 1.5) -> Dict[str, float]:
    ids = list(fns)
    weights = [1.0 / (i + 1) ** zipf_param for i in range(len(ids))]
    wsum = sum(weights)
    return {fid: total_rps * w / wsum for fid, w in zip(ids, weights)}


def zipf_stream(fns: Dict[str, FunctionSpec], duration: float,
                total_rps: float, zipf_param: float = 1.5,
                seed: int = 0) -> Iterator[TraceEvent]:
    """Average arrival rates ~ zipf over functions; exponential IATs."""
    rates = zipf_rates(fns, total_rps, zipf_param)

    def stream(fid: str, rate: float) -> Iterator[TraceEvent]:
        rng = fn_rng(seed, fid)
        return iat_stream(fid, lambda t: rng.expovariate(rate), duration)

    return merge_streams(stream(f, r) for f, r in rates.items())


# per-trace-id arrival-intensity multipliers (approximate Table-3 util
# spread); the list length defines the valid trace_id range
AZURE_TRACE_INTENSITY = (0.55, 0.65, 0.75, 1.0, 1.25, 0.6, 1.35, 0.65,
                         0.85)


def azure_params(fns: Dict[str, FunctionSpec], trace_id: int = 4,
                 scale: float = 1.0) -> Dict[str, Tuple[float, float]]:
    """Per-function (mean_iat, weibull_shape) for an Azure-like mix.
    ``trace_id`` selects the mix (the paper's Table 3 uses 9 samples of
    varying intensity); ``scale`` multiplies every arrival rate.

    Exactly 9 intensity profiles exist. Ids outside [0, 9) used to be
    silently folded ``trace_id % 9`` — same intensity bucket but a
    *different* RNG seed, so e.g. trace 12 looked like "trace 3" in a
    benchmark CSV while sampling a mix trace 3 never produced. That
    aliasing is now an error."""
    if not 0 <= trace_id < len(AZURE_TRACE_INTENSITY):
        raise ValueError(
            f"trace_id must be in [0, {len(AZURE_TRACE_INTENSITY)}) — the "
            f"paper's Table 3 has exactly {len(AZURE_TRACE_INTENSITY)} "
            f"trace samples; got {trace_id}")
    rng = random.Random(1000 + trace_id)
    # intensity profile per trace id (approximate Table-3 util spread)
    intensity = AZURE_TRACE_INTENSITY[trace_id] * scale
    out: Dict[str, Tuple[float, float]] = {}
    for fid in fns:
        # mean IAT lognormal: heavy right tail (rare functions); median
        # calibrated so trace 3 (~intensity 1.0, 19-24 fns) lands around
        # 70% device utilization at D=2, like the paper's medium trace
        mean_iat = rng.lognormvariate(math.log(44.0), 1.2) / intensity
        shape = rng.uniform(0.6, 0.9)  # Weibull shape < 1 -> bursty, CV > 1
        out[fid] = (mean_iat, shape)
    return out


def azure_stream(fns: Dict[str, FunctionSpec], duration: float,
                 trace_id: int = 4, scale: float = 1.0
                 ) -> Iterator[TraceEvent]:
    """Heavy-tailed Azure-sample-like trace, lazily generated."""
    params = azure_params(fns, trace_id=trace_id, scale=scale)

    def stream(fid: str, mean_iat: float, shape: float
               ) -> Iterator[TraceEvent]:
        rng = fn_rng(1000 + trace_id, fid)
        lam = mean_iat / math.gamma(1 + 1 / shape)
        return iat_stream(fid, lambda t: rng.weibullvariate(lam, shape),
                          duration)

    return merge_streams(stream(f, m, s) for f, (m, s) in params.items())


# -- historical list APIs ---------------------------------------------------
def zipf_trace(fns: Dict[str, FunctionSpec], duration: float,
               total_rps: float, zipf_param: float = 1.5,
               seed: int = 0) -> List[TraceEvent]:
    return list(zipf_stream(fns, duration, total_rps,
                            zipf_param=zipf_param, seed=seed))


def azure_trace(fns: Dict[str, FunctionSpec], duration: float,
                trace_id: int = 4, scale: float = 1.0) -> List[TraceEvent]:
    return list(azure_stream(fns, duration, trace_id=trace_id, scale=scale))


def make_workload(kind: str, n_fns: int = 24, duration: float = 300.0,
                  total_rps: float = 2.0, trace_id: int = 4, seed: int = 0,
                  mix: List[str] = DEFAULT_MIX
                  ) -> Tuple[Dict[str, FunctionSpec], List[TraceEvent]]:
    fns = function_copies(mix, n_fns)
    if kind == "zipf":
        return fns, zipf_trace(fns, duration, total_rps, seed=seed)
    if kind == "azure":
        return fns, azure_trace(fns, duration, trace_id=trace_id)
    raise ValueError(kind)


# -- padded arrays for the vectorized batch simulator -----------------------
class PaddedArrivals(NamedTuple):
    """A whole trace materialized into fixed-shape arrays for
    ``repro.batchsim``. Built *through* ``make_workload`` so every
    per-function RNG stream is, by construction, element-wise identical
    to the lazy streams the scalar plane consumes.

    Padding convention: ``times`` beyond ``n_events`` hold ``+inf`` and
    the matching ``fn_idx`` entries hold ``-1`` — a padded slot can never
    win a "next event" argmin against any real arrival, so padding can
    never introduce phantom arrivals. ``per_fn_times`` rows are padded
    with ``+inf`` past ``per_fn_counts[i]`` for the same reason.
    """
    fn_ids: Tuple[str, ...]          # index -> fn_id (dict order)
    fns: Dict[str, FunctionSpec]
    times: "np.ndarray"              # (capacity,) float64, +inf padded
    fn_idx: "np.ndarray"             # (capacity,) int32, -1 padded
    per_fn_times: "np.ndarray"       # (F, per_fn_capacity) float64, +inf pad
    per_fn_counts: "np.ndarray"      # (F,) int32
    n_events: int                    # true merged event count


def padded_arrivals(kind: str, n_fns: int = 24, duration: float = 300.0,
                    total_rps: float = 2.0, trace_id: int = 4, seed: int = 0,
                    mix: List[str] = DEFAULT_MIX,
                    capacity: Optional[int] = None,
                    per_fn_capacity: Optional[int] = None) -> PaddedArrivals:
    """Materialize ``make_workload(kind, ...)`` into padded fixed-shape
    arrays. ``capacity``/``per_fn_capacity`` fix the array sizes (so a
    sweep over trace ids can share one jitted shape); a trace that does
    not fit raises rather than silently truncating.
    """
    import numpy as np

    fns, trace = make_workload(kind, n_fns=n_fns, duration=duration,
                               total_rps=total_rps, trace_id=trace_id,
                               seed=seed, mix=mix)
    fn_ids = tuple(fns)
    index = {fid: i for i, fid in enumerate(fn_ids)}
    n = len(trace)
    if capacity is None:
        capacity = n
    if n > capacity:
        raise ValueError(
            f"padded_arrivals capacity={capacity} cannot hold the "
            f"{n} events of {kind!r} (n_fns={n_fns}, duration={duration}, "
            f"trace_id={trace_id}); raise capacity — refusing to truncate")

    times = np.full(capacity, np.inf, dtype=np.float64)
    fn_idx = np.full(capacity, -1, dtype=np.int32)
    counts = np.zeros(len(fn_ids), dtype=np.int32)
    for k, ev in enumerate(trace):
        times[k] = ev.time
        fn_idx[k] = index[ev.fn_id]
        counts[fn_idx[k]] += 1

    max_per_fn = int(counts.max()) if n else 0
    if per_fn_capacity is None:
        per_fn_capacity = max_per_fn
    if max_per_fn > per_fn_capacity:
        worst = fn_ids[int(counts.argmax())]
        raise ValueError(
            f"padded_arrivals per_fn_capacity={per_fn_capacity} cannot "
            f"hold the {max_per_fn} arrivals of {worst!r}; raise "
            f"per_fn_capacity — refusing to truncate")
    per_fn = np.full((len(fn_ids), per_fn_capacity), np.inf,
                     dtype=np.float64)
    fill = np.zeros(len(fn_ids), dtype=np.int32)
    for k in range(n):
        i = fn_idx[k]
        per_fn[i, fill[i]] = times[k]
        fill[i] += 1

    return PaddedArrivals(fn_ids, fns, times, fn_idx, per_fn, counts, n)
