"""Azure Functions 2019/2021 invocation-trace loader + fallback generator.

The public Azure Functions traces ship per-function *minute-bucketed
invocation counts*: one CSV row per function —

    HashOwner,HashApp,HashFunction,Trigger,1,2,...,1440

where column ``m`` holds the number of invocations of that function in
minute ``m`` of the day. This module turns those rows into the repo's
streaming arrival processes behind the existing ``Scenario`` interface:

  - ``iter_azure_rows(path)`` streams CSV rows one at a time (never
    materializing the file) into compact ``AzureRow`` records (counts as
    a 4-byte ``array``, ~6 KB per function for a full day — the loader's
    memory is O(selected functions), independent of trace length).
  - ``synthetic_azure_rows(...)`` is the documented fallback: when the
    ~1 GB public CSV is absent (CI never downloads it) it generates rows
    with the SAME schema — heavy-tailed per-function rates (lognormal
    across functions, like the real trace's "extremely heavy-tailed"
    mix), per-owner diurnal modulation, Poisson minute counts —
    deterministically from ``seed``.
  - ``counts_stream(...)`` expands one row's minute counts into a sorted
    per-function arrival stream: exactly ``count`` arrivals uniformly
    placed inside each minute (counts are conserved — the thinning knob
    ``p_sample`` below is the only thing allowed to drop events), with a
    deterministic per-function RNG (``fn_rng``), so a stream's prefix
    never depends on sibling streams.
  - the ``azure-replay`` scenario merges the per-function streams
    through the k-way heap and carries a ``tenants`` map (fn_id ->
    HashOwner) for per-tenant tail/SLO reporting.

``p_sample`` thins each arrival independently with probability ``1 - p``
(binomial per-minute counts) for replaying a heavyweight trace at a
fraction of its rate without distorting the mix; rate *scaling* beyond
1x is the replay driver's ``speedup`` knob, not the loader's.
"""
from __future__ import annotations

import csv
import math
import os
import zlib
from array import array
from typing import Dict, Iterator, List, NamedTuple, Optional

from repro_torch.workloads.spec import (DEFAULT_MIX, FunctionSpec,
                                  PAPER_FUNCTIONS)
from repro_torch.workloads.traces import TraceEvent, fn_rng, merge_streams

#: environment override consulted when ``csv_path`` is not given
AZURE_TRACE_ENV = "REPRO_AZURE_TRACE"

MINUTES_PER_DAY = 1440


class AzureRow(NamedTuple):
    """One function of the trace: identity hashes + minute counts."""
    owner: str
    app: str
    func: str
    trigger: str
    counts: array          # array('I'): invocations per minute

    @property
    def total(self) -> int:
        return sum(self.counts)


# -- CSV path ---------------------------------------------------------------
def iter_azure_rows(path: str, *, minutes: Optional[int] = None
                    ) -> Iterator[AzureRow]:
    """Stream rows of an Azure invocations-per-function CSV.

    Constant memory: one row is parsed at a time. ``minutes`` truncates
    each row's count vector (replay the first N minutes of the day).
    Rows whose count columns are malformed are skipped; a file whose
    header lacks the four identity columns raises."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header is None or len(header) < 5:
            raise ValueError(
                f"{path}: not an Azure invocations-per-function CSV "
                f"(expected HashOwner,HashApp,HashFunction,Trigger,"
                f"1,2,...; got header {header!r})")
        n_cols = len(header) - 4
        take = n_cols if minutes is None else min(minutes, n_cols)
        for row in reader:
            if len(row) < 4 + take:
                continue
            try:
                counts = array("I", (int(c) for c in row[4:4 + take]))
            except ValueError:
                continue
            yield AzureRow(row[0], row[1], row[2], row[3], counts)


# -- fallback path ----------------------------------------------------------
def _poisson(rng, lam: float) -> int:
    """Poisson sample off a ``random.Random`` (stdlib has none). Knuth
    product method below lambda ~30, normal approximation above —
    minute-bucket counts don't need exact tail fidelity up there."""
    if lam <= 0.0:
        return 0
    if lam < 30.0:
        limit = math.exp(-lam)
        n, prod = 0, rng.random()
        while prod > limit:
            n += 1
            prod *= rng.random()
        return n
    return max(0, int(round(rng.gauss(lam, math.sqrt(lam)))))


def synthetic_azure_rows(n_fns: int, *, minutes: int = MINUTES_PER_DAY,
                         seed: int = 0, fns_per_owner: int = 6,
                         mean_rpm: float = 0.6) -> List[AzureRow]:
    """Fallback generator: ``n_fns`` rows in the Azure CSV schema,
    deterministic under ``seed``, no download required.

    Shape mirrors the published trace's qualitative findings: per-
    function average rates are extremely heavy-tailed (lognormal across
    functions — most functions are rare, a handful dominate), counts
    within a minute are Poisson around the function's rate, and each
    owner's functions share a diurnal phase (owners live in timezones;
    ``mean_rpm`` calibrates the across-function mean arrivals/minute)."""
    rows: List[AzureRow] = []
    # lognormal(mu, sigma=2.0): heavy right tail. E[X] = exp(mu + s^2/2),
    # so mu anchors the across-function mean at mean_rpm.
    sigma = 2.0
    mu = math.log(mean_rpm) - sigma * sigma / 2.0
    for i in range(n_fns):
        owner_i = i // fns_per_owner
        owner = f"own{owner_i:05d}"
        app = f"app{owner_i:05d}"        # one app per owner keeps it simple
        func = f"fn{i:06d}"
        rng = fn_rng(seed, f"azure-fallback/{owner}/{func}")
        base_rpm = rng.lognormvariate(mu, sigma)
        # per-owner diurnal phase + mild per-fn amplitude
        phase = 2 * math.pi * ((zlib.crc32(owner.encode()) % 1000) / 1000.0)
        amp = 0.3 + 0.5 * rng.random()
        counts = array("I")
        for m in range(minutes):
            diurnal = 1.0 + amp * math.sin(
                2 * math.pi * m / MINUTES_PER_DAY + phase)
            counts.append(_poisson(rng, base_rpm * diurnal))
        rows.append(AzureRow(owner, app, func,
                             "http" if rng.random() < 0.6 else "timer",
                             counts))
    return rows


# -- counts -> arrival stream ----------------------------------------------
def counts_stream(fn_id: str, counts, rng, *,
                  p_sample: float = 1.0) -> Iterator[TraceEvent]:
    """Expand minute-bucketed counts into a sorted arrival stream.

    Each minute ``m`` with count ``c`` emits exactly ``c`` arrivals
    (conservation — pinned by tests) uniformly placed in
    ``[60m, 60(m+1))`` and sorted within the bucket, so the stream is
    globally time-sorted (``merge_streams`` requires it). ``p_sample``
    < 1 keeps each arrival independently with probability ``p_sample``
    (binomial thinning — the minute's *expected* count scales, the mix
    doesn't). Deterministic: ``rng`` is consumed in minute order."""
    if not 0.0 < p_sample <= 1.0:
        raise ValueError(f"p_sample must be in (0, 1], got {p_sample}")
    for m, c in enumerate(counts):
        if not c:
            continue
        if p_sample < 1.0:
            c = sum(1 for _ in range(c) if rng.random() < p_sample)
            if not c:
                continue
        t0 = 60.0 * m
        times = sorted(t0 + 60.0 * rng.random() for _ in range(c))
        for t in times:
            yield TraceEvent(t, fn_id)


def _spec_for(fn_id: str, mem_scale: float = 1.0) -> FunctionSpec:
    """Stable Table-1 profile assignment: the Azure trace has no
    resource columns, so each function gets a deterministic (crc32)
    pick from the paper's mix — warm/cold/memory realism without
    coupling to row order."""
    base = PAPER_FUNCTIONS[
        DEFAULT_MIX[zlib.crc32(fn_id.encode()) % len(DEFAULT_MIX)]]
    spec = base.with_id(fn_id)
    if mem_scale != 1.0:
        from dataclasses import replace
        spec = replace(spec, mem_bytes=int(spec.mem_bytes * mem_scale))
    return spec


def load_azure_scenario(csv_path: Optional[str] = None, *,
                        n_fns: int = 64, minutes: int = 60,
                        seed: int = 0, p_sample: float = 1.0,
                        min_total: int = 1, mem_scale: float = 1.0,
                        mean_rpm: float = 0.6,
                        max_events: Optional[int] = None):
    """Build the ``azure-replay`` Scenario.

    ``csv_path`` (or ``$REPRO_AZURE_TRACE``) selects the real trace;
    when absent the synthetic fallback rows are used — same schema, so
    everything downstream (feeders, sweep driver, per-tenant reports)
    is source-agnostic. From the CSV the first ``n_fns`` rows with at
    least ``min_total`` invocations in the replayed window are taken
    (file order — deterministic); fn_ids are ``az{row}-{owner[:6]}``
    and the Scenario's ``tenants`` map carries fn_id -> HashOwner."""
    from repro_torch.workloads.scenarios import Scenario

    if csv_path is None:
        csv_path = os.environ.get(AZURE_TRACE_ENV) or None
    if csv_path:
        picked: List[AzureRow] = []
        for row in iter_azure_rows(csv_path, minutes=minutes):
            if sum(row.counts) >= min_total:
                picked.append(row)
                if len(picked) >= n_fns:
                    break
        source = f"csv:{os.path.basename(csv_path)}"
    else:
        # mean_rpm only shapes the fallback (the CSV's rates are the
        # CSV's rates); under the heavy lognormal tail most functions sit
        # far below the mean, so raising it densifies the whole stream
        picked = [r for r in synthetic_azure_rows(n_fns, minutes=minutes,
                                                  seed=seed,
                                                  mean_rpm=mean_rpm)
                  if r.total >= min_total]
        source = "synthetic-fallback"

    fns: Dict[str, FunctionSpec] = {}
    tenants: Dict[str, str] = {}
    rows: Dict[str, AzureRow] = {}
    for i, row in enumerate(picked):
        fn_id = f"az{i:04d}-{row.owner[:6]}"
        fns[fn_id] = _spec_for(fn_id, mem_scale)
        tenants[fn_id] = row.owner
        rows[fn_id] = row

    def make_stream() -> Iterator[TraceEvent]:
        def one(fid: str) -> Iterator[TraceEvent]:
            return counts_stream(fid, rows[fid].counts,
                                 fn_rng(seed, fid), p_sample=p_sample)
        return merge_streams(one(f) for f in fns)

    total = sum(r.total for r in picked)
    return Scenario(
        "azure-replay", fns,
        f"{source}, {len(fns)} fns / {len(set(tenants.values()))} "
        f"tenants, {minutes} min, {total} invocations"
        + (f", p_sample={p_sample:g}" if p_sample != 1.0 else ""),
        make_stream, max_events, tenants=tenants)


# register with the scenario catalog (kept at module bottom: scenarios.py
# never imports this module, so the edge is one-directional)
from repro_torch.workloads.scenarios import scenario as _scenario  # noqa: E402

_scenario("azure-replay")(load_azure_scenario)
