"""Named workload scenarios: the stress cases a production GPU-FaaS
control plane must survive (ROADMAP "heavy traffic, as many scenarios as
you can imagine"), built on the streaming trace primitives so any of
them runs at million-invocation scale in constant memory.

    from repro_torch.server import ServerConfig, make_server
    srv = make_server(ServerConfig(scenario="flash-crowd",
                                   scenario_kwargs={"n_fns": 64}))
    res = srv.run_scenario()

or directly:

    sc = make_scenario("azure-longtail", n_fns=1000, scale=10.0,
                       max_events=1_000_000)
    res = server.run_trace(sc.stream())

Scenarios
  flash-crowd      — steady zipf background; one function's arrival rate
                     spikes ``spike``x during a burst window (viral
                     endpoint / retry storm).
  diurnal          — every function's rate follows a day-night sinusoid;
                     exercises the anticipatory TTL machinery as queues
                     drain and revive each cycle.
  tenant-hog       — an adversarial tenant submits at many times the
                     aggregate polite-tenant rate; fairness must cap the
                     hog's service share, not its arrival share.
  cold-start-storm — a long tail of rarely-invoked functions arrives in
                     synchronized waves, each wave mostly cold starts
                     (keep-alive expired) contending for device memory.
  azure-longtail   — the paper's heavy-tailed Azure-like mix at 10x/100x
                     scale (functions and rate) for throughput testing.

Every scenario accepts ``seed`` (determinism), ``duration`` (virtual
seconds; ``inf`` allowed when ``max_events`` bounds the stream) and
``max_events`` (cap on emitted arrivals)."""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional

from repro_torch.datapath.stages import ColdStartStages
from repro_torch.workloads.spec import (DEFAULT_MIX, GB, FunctionSpec,
                                  function_copies)
from repro_torch.workloads.traces import (TraceEvent, azure_params, fn_rng,
                                    iat_stream, merge_streams,
                                    thinned_poisson_stream, zipf_rates)


@dataclass
class Scenario:
    name: str
    fns: Dict[str, FunctionSpec]
    description: str
    make_stream: Callable[[], Iterator[TraceEvent]]
    max_events: Optional[int] = None
    # fn_id -> tenant (billing/SLO aggregation unit). None = derive from
    # the fn_id's base-family prefix ("imagenet-3" -> "imagenet"); the
    # Azure replay loader fills it with the trace's HashOwner column.
    tenants: Optional[Dict[str, str]] = None
    # seeded FaultPlan (repro.faults) for chaos-* variants; make_server
    # adopts it into the ServerConfig so sim and wallclock replay the
    # identical fault sequence. None = fault-free.
    faults: Optional[object] = None

    def stream(self) -> Iterator[TraceEvent]:
        s = self.make_stream()
        if self.max_events is not None:
            s = itertools.islice(s, self.max_events)
        return s

    def tenant_of(self, fn_id: str) -> str:
        """Tenant owning ``fn_id`` (per-tenant tail/SLO reporting)."""
        if self.tenants is not None:
            return self.tenants.get(fn_id, fn_id)
        return fn_id.rsplit("-", 1)[0]

    def shard_streams(self, n_shards: int,
                      route: Optional[Callable[[str], int]] = None,
                      mode: str = "demux",
                      buffer_cap: Optional[int] = 65536) -> list:
        """Per-shard arrival fan-out: the scenario's (bounded) stream
        split into ``n_shards`` time-sorted sub-streams by ``route``
        (fn_id -> shard; defaults to the control plane's stable crc32
        hash router, so a fan-out partition agrees with a
        ``sharding="hash"`` server's own routing). ``max_events`` caps
        the *global* stream before the split, so the union over shards
        is exactly ``stream()``.

        ``mode="demux"`` (default): ONE shared replay of the scenario,
        split single-pass into per-shard buffers — O(total events) RNG
        work for the whole fan-out, thread-safe, built for concurrent
        consumers (the open-loop shard feeders). A consumer that runs
        far ahead of its siblings accumulates their events in their
        buffers; ``buffer_cap`` bounds that imbalance and raises with
        guidance instead of silently holding the whole trace (pass
        ``None`` to unbound it). Consuming only ONE of the returned
        streams to exhaustion is exactly that worst case — use
        ``mode="filter"`` there.

        ``mode="filter"``: the historical implementation, retained as
        the differential reference and for single-stream consumers
        (e.g. one shard process that only wants its own partition):
        each sub-stream independently replays the scenario and filters,
        O(n_shards x total events) RNG regeneration in aggregate but
        zero cross-stream state."""
        if route is None:
            from repro_torch.server.shard import hash_shard
            route = lambda fn_id: hash_shard(fn_id, n_shards)

        if mode == "filter":
            def one(k: int) -> Iterator[TraceEvent]:
                return (ev for ev in self.stream() if route(ev.fn_id) == k)
            return [one(k) for k in range(n_shards)]
        if mode != "demux":
            raise ValueError(f"unknown shard_streams mode {mode!r}; "
                             f"expected 'demux' or 'filter'")
        demux = _StreamDemux(self.stream(), n_shards, route, buffer_cap)
        return [demux.stream(k) for k in range(n_shards)]


class _StreamDemux:
    """Single-pass fan-out of one time-sorted event stream into N
    per-shard sub-streams. Consumers pull: a shard whose buffer is empty
    advances the shared iterator under a lock, parking events routed to
    other shards in their buffers. Per-shard order is the global
    stream's arrival order restricted to that shard — identical to the
    filter implementation (tests/test_replay.py proves union and
    per-shard order equivalence)."""

    def __init__(self, stream: Iterator[TraceEvent], n_shards: int,
                 route: Callable[[str], int],
                 buffer_cap: Optional[int]):
        import collections
        import threading
        self._it = iter(stream)
        self._route = route
        self._bufs = [collections.deque() for _ in range(n_shards)]
        self._cap = buffer_cap
        self._lock = threading.Lock()
        self._done = False

    def stream(self, k: int) -> Iterator[TraceEvent]:
        buf = self._bufs[k]
        route = self._route
        bufs = self._bufs
        cap = self._cap
        while True:
            if not buf:
                with self._lock:
                    # re-check under the lock: a sibling may have parked
                    # events for us while we waited on it
                    while not buf and not self._done:
                        ev = next(self._it, None)
                        if ev is None:
                            self._done = True
                            break
                        j = route(ev.fn_id)
                        b = bufs[j]
                        b.append(ev)
                        if j != k and cap is not None and len(b) > cap:
                            raise RuntimeError(
                                f"shard_streams demux: shard {j}'s "
                                f"buffer exceeded {cap} events while "
                                f"shard {k} consumed — consumers are "
                                f"too imbalanced (or only one stream "
                                f"is being drained; use mode='filter' "
                                f"for that, or raise buffer_cap)")
                if not buf:
                    return
            yield buf.popleft()


SCENARIOS: Dict[str, Callable[..., Scenario]] = {}


def scenario(name: str):
    def register(builder):
        SCENARIOS[name] = builder
        return builder
    return register


def make_scenario(name: str, **kw) -> Scenario:
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}") from None
    return builder(**kw)


@scenario("flash-crowd")
def flash_crowd(n_fns: int = 24, duration: float = 600.0,
                total_rps: float = 2.0, spike: float = 50.0,
                burst_start: float = 120.0, burst_len: float = 60.0,
                seed: int = 0, max_events: Optional[int] = None) -> Scenario:
    fns = function_copies(DEFAULT_MIX, n_fns)
    rates = zipf_rates(fns, total_rps)
    crowd = list(fns)[min(2, n_fns - 1)]   # a mid-popularity endpoint

    def make_stream() -> Iterator[TraceEvent]:
        def one(fid: str) -> Iterator[TraceEvent]:
            rng = fn_rng(seed, fid)
            base = rates[fid]
            if fid != crowd:
                return iat_stream(fid, lambda t: rng.expovariate(base),
                                  duration)
            rate_fn = lambda t: base * (
                spike if burst_start <= t < burst_start + burst_len else 1.0)
            return thinned_poisson_stream(fid, rate_fn, base * spike,
                                          duration, rng)
        return merge_streams(one(f) for f in fns)

    return Scenario("flash-crowd", fns,
                    f"{spike:g}x spike on {crowd} during "
                    f"[{burst_start:g}, {burst_start + burst_len:g})s",
                    make_stream, max_events)


@scenario("diurnal")
def diurnal(n_fns: int = 24, duration: float = 1200.0,
            total_rps: float = 2.0, period: float = 300.0,
            amplitude: float = 0.85, seed: int = 0,
            max_events: Optional[int] = None) -> Scenario:
    fns = function_copies(DEFAULT_MIX, n_fns)
    rates = zipf_rates(fns, total_rps)

    def make_stream() -> Iterator[TraceEvent]:
        def one(fid: str) -> Iterator[TraceEvent]:
            rng = fn_rng(seed, fid)
            base = rates[fid]
            # stagger phases so "days" don't align perfectly across fns
            phase = 2 * math.pi * (zlib_frac(fid))
            rate_fn = lambda t: base * (
                1.0 + amplitude * math.sin(2 * math.pi * t / period + phase))
            return thinned_poisson_stream(fid, rate_fn,
                                          base * (1.0 + amplitude),
                                          duration, rng)
        return merge_streams(one(f) for f in fns)

    return Scenario("diurnal", fns,
                    f"sinusoidal load, period {period:g}s, "
                    f"amplitude {amplitude:g}",
                    make_stream, max_events)


@scenario("tenant-hog")
def tenant_hog(n_fns: int = 24, duration: float = 600.0,
               polite_rps: float = 1.5, hog_factor: float = 20.0,
               seed: int = 0, max_events: Optional[int] = None) -> Scenario:
    fns = function_copies(DEFAULT_MIX, n_fns)
    ids = list(fns)
    hog = ids[0]
    polite = ids[1:]
    per_polite = polite_rps / max(len(polite), 1)
    hog_rate = polite_rps * hog_factor

    def make_stream() -> Iterator[TraceEvent]:
        def one(fid: str) -> Iterator[TraceEvent]:
            rng = fn_rng(seed, fid)
            rate = hog_rate if fid == hog else per_polite
            return iat_stream(fid, lambda t: rng.expovariate(rate), duration)
        return merge_streams(one(f) for f in ids)

    return Scenario("tenant-hog", fns,
                    f"{hog} floods at {hog_factor:g}x the aggregate "
                    f"polite rate",
                    make_stream, max_events)


def _llm_endpoint_fns(n_fns: int, h2d_bw: float) -> Dict[str, FunctionSpec]:
    """Transfer-dominated endpoint mix (the FaaSTube regime): multi-GB
    weights behind short fixed setup/compile stages, seconds-scale
    service — cold starts are dominated by the host->HBM upload, which
    is exactly what the pipeline datapath can overlap and prefetch.
    Deterministic: spec k cycles a fixed size/service table."""
    sizes_gb = (4, 6, 8, 10, 14)
    warm_s = (0.8, 1.3, 1.8, 2.4, 3.0)
    demand = (0.45, 0.5, 0.55, 0.6, 0.5)
    out: Dict[str, FunctionSpec] = {}
    for i in range(n_fns):
        k = i % len(sizes_gb)
        mem = sizes_gb[k] * GB
        st = ColdStartStages(setup_s=0.3, compile_s=1.2, weight_bytes=mem)
        fid = f"llm-{i}"
        out[fid] = FunctionSpec(fid, warm_time=warm_s[k],
                                cold_init=st.scalar_cold_init(h2d_bw),
                                mem_bytes=mem, demand=demand[k],
                                kind="endpoint", stages=st)
    return out


def _scale_mem(fns: Dict[str, FunctionSpec],
               mem_scale: float) -> Dict[str, FunctionSpec]:
    """Scale the resident working set only (``cold_init`` untouched):
    a pressure knob for memory/datapath experiments."""
    if mem_scale == 1.0:
        return fns
    from dataclasses import replace
    return {f: replace(s, mem_bytes=int(s.mem_bytes * mem_scale))
            for f, s in fns.items()}


@scenario("cold-start-storm")
def cold_start_storm(n_fns: int = 96, duration: float = 900.0,
                     wave_period: float = 120.0, wave_width: float = 5.0,
                     participation: float = 0.7, seed: int = 0,
                     spec_profile: str = "paper", mem_scale: float = 1.0,
                     llm_h2d_bw: float = 16 * GB,
                     max_events: Optional[int] = None) -> Scenario:
    """Sparse functions arriving in synchronized waves: between waves the
    anticipatory TTL (alpha * IAT ~ alpha * wave_period) and keep-alive
    policies decide who stays resident; each wave front-loads cold
    starts and memory churn.

    ``spec_profile="paper"`` waves the Table-1 copies; ``"llm"`` waves
    the transfer-dominated endpoint mix (``llm_h2d_bw`` must match the
    server's ``h2d_bw`` for the scalar cold model to agree with the
    pipeline stages). ``mem_scale`` multiplies working sets."""
    if spec_profile == "llm":
        fns = _llm_endpoint_fns(n_fns, llm_h2d_bw)
    elif spec_profile == "paper":
        fns = function_copies(DEFAULT_MIX, n_fns)
    else:
        raise ValueError(f"unknown spec_profile {spec_profile!r}; "
                         f"expected 'paper' or 'llm'")
    fns = _scale_mem(fns, mem_scale)
    # jitter must stay inside the wave spacing or per-function streams
    # would emit out of order (merge_streams requires sorted inputs)
    jitter = min(wave_width, wave_period)

    def make_stream() -> Iterator[TraceEvent]:
        def one(fid: str) -> Iterator[TraceEvent]:
            rng = fn_rng(seed, fid)
            wave = 0
            while True:
                wave += 1
                t = wave * wave_period
                if t >= duration:
                    return
                if rng.random() < participation:
                    ev_t = t + rng.uniform(0.0, jitter)
                    if ev_t < duration:
                        yield TraceEvent(ev_t, fid)
        return merge_streams(one(f) for f in fns)

    return Scenario("cold-start-storm", fns,
                    f"{n_fns} sparse fns, waves every {wave_period:g}s",
                    make_stream, max_events)


@scenario("azure-longtail")
def azure_longtail(n_fns: int = 240, duration: float = float("inf"),
                   trace_id: int = 3, scale: float = 10.0, seed: int = 0,
                   total_rps: Optional[float] = None,
                   mem_scale: float = 1.0,
                   max_events: Optional[int] = 100_000) -> Scenario:
    """The paper's heavy-tailed mix scaled up: 10x/100x the function
    count and aggregate rate of the Table-3 samples. Defaults stream
    forever (duration=inf) capped by ``max_events``. ``total_rps``
    renormalizes the aggregate expected arrival rate (keeping the
    heavy-tailed per-function mix) so long replays can be pinned at a
    stable operating point instead of unbounded-backlog overload;
    ``mem_scale`` multiplies working sets (datapath/memory pressure)."""
    fns = _scale_mem(function_copies(DEFAULT_MIX, n_fns), mem_scale)
    params = azure_params(fns, trace_id=trace_id, scale=scale)
    if total_rps is not None:
        agg = sum(1.0 / m for m, _ in params.values())
        params = {f: (m * agg / total_rps, s)
                  for f, (m, s) in params.items()}

    def make_stream() -> Iterator[TraceEvent]:
        def one(fid: str) -> Iterator[TraceEvent]:
            rng = fn_rng(1000 + trace_id + seed, fid)
            mean_iat, shape = params[fid]
            lam = mean_iat / math.gamma(1 + 1 / shape)
            return iat_stream(fid,
                              lambda t: rng.weibullvariate(lam, shape),
                              duration)
        return merge_streams(one(f) for f in fns)

    # trace_id is part of the workload's identity (it selects the Table-3
    # mix AND the RNG seed): surface it so benchmark CSVs carrying the
    # description are self-identifying
    return Scenario("azure-longtail", fns,
                    f"{n_fns} fns, {scale:g}x Azure-like intensity, "
                    f"trace_id={trace_id}",
                    make_stream, max_events)


def zlib_frac(fn_id: str) -> float:
    """Stable per-function fraction in [0, 1) (phase staggering)."""
    import zlib
    return (zlib.crc32(fn_id.encode()) % 10_000) / 10_000.0


# -- chaos variants (repro.faults) ------------------------------------------
def _chaosify(base: Scenario, *, chaos_seed: int, horizon_s: float,
              n_devices: int, device_faults: int, device_down_s: float,
              permanent_devices: int, endpoint_fault_frac: float,
              endpoint_faults_per_fn: int, endpoint_hang_frac: float,
              transfer_faults: int) -> Scenario:
    """Attach a seeded ``FaultPlan`` to an existing scenario: same
    arrival process (same workload seed), plus a deterministic fault
    schedule the server adopts via ``ServerConfig``."""
    from repro_torch.faults import FaultPlan
    base.faults = FaultPlan.generate(
        seed=chaos_seed, horizon_s=horizon_s, n_devices=n_devices,
        fn_ids=list(base.fns), device_faults=device_faults,
        device_down_s=device_down_s, permanent_devices=permanent_devices,
        endpoint_fault_frac=endpoint_fault_frac,
        endpoint_faults_per_fn=endpoint_faults_per_fn,
        endpoint_hang_frac=endpoint_hang_frac,
        transfer_faults=transfer_faults)
    base.name = "chaos-" + base.name
    base.description += (
        f" + faults(seed={chaos_seed}: {device_faults} device, "
        f"{permanent_devices} permanent, "
        f"{endpoint_fault_frac:g} fn-frac endpoint, "
        f"{transfer_faults} transfer)")
    return base


@scenario("chaos-azure-longtail")
def chaos_azure_longtail(chaos_seed: int = 0, horizon_s: float = 120.0,
                         n_devices: int = 4, device_faults: int = 2,
                         device_down_s: float = 5.0,
                         permanent_devices: int = 0,
                         endpoint_fault_frac: float = 0.25,
                         endpoint_faults_per_fn: int = 2,
                         endpoint_hang_frac: float = 0.25,
                         transfer_faults: int = 0, **kw) -> Scenario:
    """``azure-longtail`` under fire: transient device outages plus
    error/hang endpoint faults across a quarter of the functions.
    ``horizon_s`` bounds where fault times land (the base stream has no
    finite duration); ``n_devices`` must match the server's."""
    return _chaosify(
        azure_longtail(**kw), chaos_seed=chaos_seed, horizon_s=horizon_s,
        n_devices=n_devices, device_faults=device_faults,
        device_down_s=device_down_s, permanent_devices=permanent_devices,
        endpoint_fault_frac=endpoint_fault_frac,
        endpoint_faults_per_fn=endpoint_faults_per_fn,
        endpoint_hang_frac=endpoint_hang_frac,
        transfer_faults=transfer_faults)


@scenario("chaos-cold-start-storm")
def chaos_cold_start_storm(chaos_seed: int = 0,
                           horizon_s: Optional[float] = None,
                           n_devices: int = 4, device_faults: int = 1,
                           device_down_s: float = 10.0,
                           permanent_devices: int = 0,
                           endpoint_fault_frac: float = 0.15,
                           endpoint_faults_per_fn: int = 1,
                           endpoint_hang_frac: float = 0.25,
                           transfer_faults: int = 4, **kw) -> Scenario:
    """``cold-start-storm`` with transfer aborts landing mid-wave (the
    H2D pipeline's worst case) plus a device outage."""
    base = cold_start_storm(**kw)
    if horizon_s is None:
        horizon_s = kw.get("duration", 900.0)
    return _chaosify(
        base, chaos_seed=chaos_seed, horizon_s=horizon_s,
        n_devices=n_devices, device_faults=device_faults,
        device_down_s=device_down_s, permanent_devices=permanent_devices,
        endpoint_fault_frac=endpoint_fault_frac,
        endpoint_faults_per_fn=endpoint_faults_per_fn,
        endpoint_hang_frac=endpoint_hang_frac,
        transfer_faults=transfer_faults)


@scenario("chaos-flash-crowd")
def chaos_flash_crowd(chaos_seed: int = 0,
                      horizon_s: Optional[float] = None,
                      n_devices: int = 4, device_faults: int = 1,
                      device_down_s: float = 30.0,
                      permanent_devices: int = 1,
                      endpoint_fault_frac: float = 0.25,
                      endpoint_faults_per_fn: int = 2,
                      endpoint_hang_frac: float = 0.25,
                      transfer_faults: int = 0, **kw) -> Scenario:
    """``flash-crowd`` where a device dies for good near the spike: the
    retry storm meets degraded capacity — the scenario the SLO-aware
    shedding exists for."""
    base = flash_crowd(**kw)
    if horizon_s is None:
        horizon_s = kw.get("duration", 600.0)
    return _chaosify(
        base, chaos_seed=chaos_seed, horizon_s=horizon_s,
        n_devices=n_devices, device_faults=device_faults,
        device_down_s=device_down_s, permanent_devices=permanent_devices,
        endpoint_fault_frac=endpoint_fault_frac,
        endpoint_faults_per_fn=endpoint_faults_per_fn,
        endpoint_hang_frac=endpoint_hang_frac,
        transfer_faults=transfer_faults)
