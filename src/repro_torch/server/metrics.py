"""Shared result/metrics API for simulated and wall-clock runs.

``RunResult`` carries the invocation records plus the control-plane
accounting objects (fairness tracker, warm pool, device states) and
exposes the latency / fairness / utilization accessors the benchmarks
use. The simulator's historical ``SimResult`` name is an alias.
"""
from __future__ import annotations

import math
import random
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fairness import FairnessTracker
from repro_torch.runtime.invocation import Invocation


def nearest_rank(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted sequence: the
    smallest element whose cumulative frequency is >= q, i.e. index
    ``ceil(q*n) - 1`` (zero-based), clamped to the valid range.

    This is THE quantile helper — ``StreamingStats``, ``RunResult`` and
    the benchmarks all route through it. The three historical copies
    indexed ``sorted(xs)[int(q*(n-1))]``, which *truncates* the rank and
    floor-biases upper tails: at n=5 the "p90" was the 4th value, not
    the max, and a p999 over a few thousand samples could sit a full
    rank below the nearest-rank definition. Tail gates built on those
    numbers under-reported regressions."""
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    i = math.ceil(q * n) - 1
    if i < 0:
        i = 0
    elif i >= n:
        i = n - 1
    return sorted_xs[i]


def quantile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of an unsorted sequence (sorts a copy)."""
    return nearest_rank(sorted(xs), q)


class StreamingStats:
    """Constant-memory run summary for ``metrics="lean"`` executions:
    exact counts / means / per-function service totals plus a fixed-size
    reservoir sample (seeded, deterministic) for latency quantiles. Lets
    the simulator replay million-invocation traces without materializing
    the invocation list."""

    RESERVOIR = 8192

    def __init__(self, seed: int = 0):
        self.n = 0                        # completions recorded
        self.latency_sum = 0.0
        self.latency_max = 0.0
        self.start_types: Dict[str, int] = {}
        self.service_by_fn: Dict[str, float] = {}
        self._reservoir: List[float] = []
        self._rng = random.Random(seed)

    def record(self, inv: Invocation) -> None:
        lat = inv.completion - inv.arrival      # inv.latency, no property
        n = self.n = self.n + 1
        self.latency_sum += lat
        if lat > self.latency_max:
            self.latency_max = lat
        st = self.start_types
        key = inv.start_type
        st[key] = st.get(key, 0) + 1
        sv = self.service_by_fn
        key = inv.fn_id
        sv[key] = sv.get(key, 0.0) + inv.service_time
        res = self._reservoir
        if len(res) < self.RESERVOIR:
            res.append(lat)
        else:
            j = self._rng.randrange(n)
            if j < self.RESERVOIR:
                res[j] = lat

    def mean_latency(self) -> float:
        return self.latency_sum / self.n if self.n else 0.0

    def quantile(self, q: float) -> float:
        return nearest_rank(sorted(self._reservoir), q)

    def slo_attainment(self, slo_s: float) -> float:
        """Fraction of completions within ``slo_s`` end-to-end latency,
        estimated from the reservoir (exact while n <= RESERVOIR)."""
        res = self._reservoir
        if not res:
            return 0.0
        return sum(1 for lat in res if lat <= slo_s) / len(res)


class MergedPools:
    """Aggregate warm-pool view over a sharded plane's per-shard pools:
    the counters ``RunResult`` and the benchmarks read, summed across
    shards. ``pools`` keeps the per-shard objects for drill-down."""

    def __init__(self, pools: List):
        self.pools = list(pools)

    def _sum(self, attr: str) -> int:
        return sum(getattr(p, attr) for p in self.pools)

    @property
    def cold_starts(self) -> int:
        return self._sum("cold_starts")

    @property
    def warm_starts(self) -> int:
        return self._sum("warm_starts")

    @property
    def host_warm_starts(self) -> int:
        return self._sum("host_warm_starts")

    @property
    def evictions(self) -> int:
        return self._sum("evictions")

    def count(self, fn_id: Optional[str] = None) -> int:
        return sum(p.count(fn_id) for p in self.pools)

    @property
    def cold_hit_pct(self) -> float:
        total = self.cold_starts + self.warm_starts + self.host_warm_starts
        return 100.0 * self.cold_starts / total if total else 0.0


class MergedFairness:
    """Aggregate fairness view over per-shard ``FairnessTracker``s.

    Fairness windows are evaluated *within* a shard (Eq. 1's bound is a
    per-dispatcher property — the cross-shard guarantee comes from the
    epoch-synchronized VT floor, not from comparing flows that never
    contend for the same devices). ``windows`` is the time-ordered merge
    of every shard's records; ``trackers`` keeps per-shard access for
    the drift/stress tests."""

    def __init__(self, trackers: List[FairnessTracker]):
        self.trackers = list(trackers)
        self.window = trackers[0].window if trackers else 0.0
        self.T = trackers[0].T if trackers else 0.0
        self.D = trackers[0].D if trackers else 0

    @property
    def windows(self) -> List:
        import heapq
        # each tracker appends windows in increasing t0, so the merge is
        # O(total) per access — no full re-sort
        return list(heapq.merge(*(t.windows for t in self.trackers),
                                key=lambda w: (w.t0, w.t1)))


@dataclass
class RunResult:
    policy: str
    invocations: List[Invocation]
    fairness: FairnessTracker
    pool: object             # WarmPool (indexed or reference layer)
    util_samples: List[Tuple[float, float]]
    devices: List            # List[DeviceState]
    duration: float
    # lean-mode (streaming) extras: aggregate stats instead of the full
    # invocation list, and the utilization time-integral instead of the
    # per-event sample trace
    stats: Optional[StreamingStats] = None
    util_integral: float = 0.0
    # fault plane (repro.faults): injector counter snapshot when the run
    # had a FaultPlan, else None; cross-shard VT epochs that raised
    faults: Optional[object] = None       # FaultStats
    vt_sync_errors: int = 0

    # -- latency ------------------------------------------------------------
    def mean_latency(self) -> float:
        if not self.invocations and self.stats is not None:
            return self.stats.mean_latency()
        done = [i for i in self.invocations if i.done and not i.failed]
        return statistics.fmean(i.latency for i in done) if done else 0.0

    def per_fn_latency(self) -> Dict[str, List[float]]:
        if not self.invocations and self.stats is not None:
            raise ValueError(
                "per-function latency needs full invocation records; "
                "this run used metrics='lean' (per-fn *service* totals "
                "are available as stats.service_by_fn)")
        out: Dict[str, List[float]] = {}
        for i in self.invocations:
            if i.done:
                out.setdefault(i.fn_id, []).append(i.latency)
        return out

    def per_fn_mean(self) -> Dict[str, float]:
        return {f: statistics.fmean(v)
                for f, v in self.per_fn_latency().items()}

    def inter_fn_variance(self) -> float:
        means = list(self.per_fn_mean().values())
        return statistics.pvariance(means) if len(means) > 1 else 0.0

    def intra_fn_variance(self) -> Dict[str, float]:
        return {f: (statistics.pvariance(v) if len(v) > 1 else 0.0)
                for f, v in self.per_fn_latency().items()}

    def latency_quantile(self, q: float) -> float:
        if not self.invocations and self.stats is not None:
            return self.stats.quantile(q)
        lats = sorted(i.latency for i in self.invocations
                      if i.done and not i.failed)
        return nearest_rank(lats, q)

    def latency_quantiles(self, qs: Sequence[float]) -> List[float]:
        """Several quantiles off one sort (tail reports ask for
        p50/p99/p999 together)."""
        if not self.invocations and self.stats is not None:
            lats = sorted(self.stats._reservoir)
        else:
            lats = sorted(i.latency for i in self.invocations
                          if i.done and not i.failed)
        return [nearest_rank(lats, q) for q in qs]

    def p50_latency(self) -> float:
        return self.latency_quantile(0.50)

    def p99_latency(self) -> float:
        return self.latency_quantile(0.99)

    def p999_latency(self) -> float:
        return self.latency_quantile(0.999)

    def slo_attainment(self, slo_s: float) -> float:
        """Fraction of completed invocations with end-to-end latency
        within ``slo_s`` (the replay harness's SLO curves; exact on full
        metrics, reservoir-estimated on lean runs)."""
        if not self.invocations and self.stats is not None:
            return self.stats.slo_attainment(slo_s)
        done = tot = 0
        for i in self.invocations:
            if i.done and not i.failed:
                tot += 1
                if i.latency <= slo_s:
                    done += 1
        return done / tot if tot else 0.0

    # -- utilization ---------------------------------------------------------
    def mean_utilization(self) -> float:
        if not self.util_samples:
            return self.util_integral / max(self.duration, 1e-9)
        # time-weighted
        tot, last_t, last_u = 0.0, 0.0, 0.0
        for t, u in self.util_samples:
            tot += last_u * (t - last_t)
            last_t, last_u = t, u
        return tot / max(self.duration, 1e-9)

    # -- service/fairness -----------------------------------------------------
    def service_time_by_fn(self, t0: float, t1: float) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for i in self.invocations:
            if i.exec_start is None or i.completion is None:
                continue
            lo, hi = max(i.exec_start, t0), min(i.completion, t1)
            if hi > lo:
                out[i.fn_id] = out.get(i.fn_id, 0.0) + (hi - lo)
        return out

    # -- start types ----------------------------------------------------------
    def start_type_counts(self) -> Dict[str, int]:
        if not self.invocations and self.stats is not None:
            return dict(self.stats.start_types)
        out: Dict[str, int] = {}
        for i in self.invocations:
            if i.done:
                out[i.start_type] = out.get(i.start_type, 0) + 1
        return out

    @property
    def completed_count(self) -> int:
        if not self.invocations and self.stats is not None:
            return self.stats.n
        return sum(1 for i in self.invocations if i.done)

    # -- fault plane ----------------------------------------------------------
    @property
    def failed_count(self) -> int:
        return sum(1 for i in self.invocations if i.failed)

    @property
    def shed_count(self) -> int:
        return sum(1 for i in self.invocations if i.shed)

    def goodput(self) -> float:
        """Fraction of arrivals that completed *successfully*. Under
        fault injection this is exact from the injector's counters
        (shed, dropped, and failed-completed arrivals all count against
        it); fault-free full-metrics runs derive it from the records;
        fault-free lean runs are 1.0 by construction."""
        f = self.faults
        if f is not None and f.arrivals:
            return f.completed_ok / f.arrivals
        if not self.invocations:
            return 1.0
        ok = sum(1 for i in self.invocations
                 if i.done and not i.failed and not i.shed)
        return ok / len(self.invocations)

    def phase_quantiles(self, qs: Sequence[float]
                        ) -> Dict[str, List[float]]:
        """Per-phase tails over successful completions: queue wait
        (arrival -> dispatch), overhead (dispatch -> exec start),
        service, and end-to-end latency. Requires full invocation
        records (lean runs keep only end-to-end latency)."""
        phases: Dict[str, List[float]] = {
            "queue": [], "overhead": [], "service": [], "latency": []}
        for i in self.invocations:
            if not i.done or i.failed or i.shed:
                continue
            ov = i.overhead if i.overhead is not None else 0.0
            if i.exec_start is not None:
                w = i.exec_start - ov - i.arrival
                phases["queue"].append(w if w > 0.0 else 0.0)
            phases["overhead"].append(ov)
            phases["service"].append(
                i.service_time if i.service_time is not None else 0.0)
            phases["latency"].append(i.latency)
        out: Dict[str, List[float]] = {}
        for k, v in phases.items():
            v.sort()
            out[k] = [nearest_rank(v, q) for q in qs]
        return out
