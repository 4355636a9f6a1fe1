"""Open-loop trace replay against the wall-clock executors.

The sim executor replays a trace on a *virtual* clock; this module
replays the same ``Scenario`` streams against ``WallClockExecutor`` /
``ShardedWallClockExecutor`` in real time, open-loop: each arrival is
released at

    origin + ev.time / speedup

and **never early** — an open-loop source does not slow down when the
server backs up (that closed-loop coupling is exactly what hides
saturation; the paper's load experiments are open-loop for the same
reason). When the feeder itself falls behind (submit overhead, GIL,
oversubscribed box) the slip is recorded as per-invocation *lateness*,
kept strictly separate from queueing delay: ``Invocation.arrival`` is
stamped at actual release, so server-side latency starts after the slip
and a saturated feeder can't masquerade as a saturated server (a replay
whose lateness tail blows up is invalid as a *load* measurement — the
sweep driver checks exactly that).

Feeding is sharded like the serving path: against a sharded executor one
feeder thread per shard consumes the scenario's single-pass demux
fan-out (``Scenario.shard_streams``) and submits straight into its
shard's executor, so the feed side scales with the shard count instead
of bottlenecking on one thread walking the merged stream.

    srv = make_server(ServerConfig(executor="wallclock", n_shards=4,
                                   n_devices=8, d=2), endpoints=eps)
    rr = replay_open_loop(srv, sc, speedup=600.0)
    rr.result.p99_latency(), rr.lateness_quantile(0.99),
    rr.per_tenant_quantiles(sc)
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.server.executors import (Server, ShardedWallClockExecutor,
                                    WallClockExecutor)
from repro_torch.server.metrics import RunResult, nearest_rank
from repro_torch.workloads.scenarios import Scenario
from repro_torch.workloads.traces import TraceEvent

# feeders sleep in chunks so a stop request is honored promptly even
# mid-gap on a sparse trace
_MAX_SLEEP = 0.25


class OpenLoopFeeder(threading.Thread):
    """Release a time-sorted arrival stream into ``submit`` on schedule.

    ``submit(fn_id)`` must return the created ``Invocation`` (both
    executors' submit does); the feeder stamps ``inv.lateness``.
    Pacing uses ``time.monotonic`` against a caller-supplied ``origin``
    so all feeders of one replay share a clock. Releases are never
    early: the sleep loop re-checks the clock until the target has
    passed (``time.sleep`` may wake late, never usefully early)."""

    def __init__(self, submit: Callable[[str], object],
                 stream: Iterator[TraceEvent], origin: float,
                 speedup: float = 1.0, name: str = "feeder",
                 injector=None):
        super().__init__(name=f"openloop-{name}", daemon=True)
        if speedup <= 0.0:
            raise ValueError(f"speedup must be > 0, got {speedup}")
        self._submit = submit
        self._stream = stream
        self._origin = origin
        self._speedup = speedup
        # NB: not ``_stop`` — threading.Thread has a private method of
        # that name which join() calls internally
        self._stop_evt = threading.Event()
        self.released = 0
        self.lateness: List[float] = []
        self.error: Optional[BaseException] = None
        # fault plane: (trace_t, down_s) kill/restart windows — the
        # feeder "dies" at trace-time t and releases the backlog when it
        # "restarts" down_s trace-seconds later; the slip lands in the
        # ordinary lateness accounting. ``injector`` (shared
        # FaultInjector) counts the kills.
        self._outages: List[tuple] = []
        self._injector = injector

    def add_outage(self, t: float, down_s: float) -> None:
        self._outages.append((t, down_s))

    def stop(self) -> None:
        self._stop_evt.set()

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:       # surfaced by replay_open_loop
            self.error = e

    def _run(self) -> None:
        submit = self._submit
        origin = self._origin
        inv_speed = 1.0 / self._speedup
        stopping = self._stop_evt.is_set
        monotonic = time.monotonic
        lateness = self.lateness
        outages = sorted(self._outages)
        oi = 0
        restart_at = float("-inf")      # wall time the last kill lifts
        for ev in self._stream:
            sched = origin + ev.time * inv_speed
            while oi < len(outages) and ev.time >= outages[oi][0]:
                t0, down = outages[oi]
                oi += 1
                rt = origin + (t0 + down) * inv_speed
                if rt > restart_at:
                    restart_at = rt
                if self._injector is not None:
                    self._injector.feeder_kills += 1
            # pace against the restart when down, but measure lateness
            # against the ORIGINAL schedule — the outage slip must show
            # up in the feed-side accounting, not hide in it
            target = restart_at if restart_at > sched else sched
            while True:
                delta = target - monotonic()
                if delta <= 0.0:
                    break
                if stopping():
                    return
                time.sleep(delta if delta < _MAX_SLEEP else _MAX_SLEEP)
            if stopping():
                return
            inv = submit(ev.fn_id)
            late = monotonic() - sched
            inv.lateness = late
            lateness.append(late)
            self.released += 1


@dataclass
class ReplayResult:
    """Wall-clock replay outcome: the executor's ``RunResult`` plus the
    feed-side accounting the open-loop contract requires."""
    result: RunResult
    lateness: List[float]           # sorted, one entry per released arrival
    released: int                   # arrivals released by the feeders
    wall_s: float                   # feed start -> executor stop
    speedup: float
    n_feeders: int

    def lateness_quantile(self, q: float) -> float:
        return nearest_rank(self.lateness, q)

    @property
    def max_lateness(self) -> float:
        return self.lateness[-1] if self.lateness else 0.0

    def throughput(self) -> float:
        """Completions per wall second."""
        done = self.result.completed_count
        return done / self.wall_s if self.wall_s > 0 else 0.0

    # -- breakdowns ---------------------------------------------------------
    def _groups(self, key: Callable[[str], object]
                ) -> Dict[object, List[float]]:
        out: Dict[object, List[float]] = {}
        for inv in self.result.invocations:
            if inv.done:
                out.setdefault(key(inv.fn_id), []).append(inv.latency)
        for lats in out.values():
            lats.sort()
        return out

    def per_tenant_quantiles(self, scenario: Scenario,
                             qs: Tuple[float, ...] = (0.5, 0.99, 0.999),
                             slo_s: Optional[float] = None
                             ) -> Dict[str, Dict[str, float]]:
        """Per-tenant tail summary: ``{tenant: {"n": .., "p50": ..,
        "p99": .., "p999": .., ["slo": ..]}}`` over completed
        invocations (tenancy from ``scenario.tenant_of``)."""
        out: Dict[str, Dict[str, float]] = {}
        for tenant, lats in self._groups(scenario.tenant_of).items():
            row = {"n": float(len(lats))}
            for q in qs:
                row[_qname(q)] = nearest_rank(lats, q)
            if slo_s is not None:
                row["slo"] = sum(1 for x in lats if x <= slo_s) / len(lats)
            out[tenant] = row
        return out

    def per_shard_quantiles(self, n_shards: int,
                            qs: Tuple[float, ...] = (0.5, 0.99, 0.999)
                            ) -> Dict[int, Dict[str, float]]:
        """Per-shard tails, recomputed from the stable hash route (the
        sharded executor's hash mode routes with the same function, so
        this is the serving shard, not a re-guess)."""
        from repro_torch.server.shard import hash_shard
        out: Dict[int, Dict[str, float]] = {}
        for k, lats in self._groups(
                lambda f: hash_shard(f, n_shards)).items():
            row = {"n": float(len(lats))}
            for q in qs:
                row[_qname(q)] = nearest_rank(lats, q)
            out[k] = row
        return out

    def slo_attainment(self, slo_s: float) -> float:
        return self.result.slo_attainment(slo_s)


def _qname(q: float) -> str:
    return "p" + f"{q}".replace("0.", "").ljust(2, "0")[:3]


def replay_open_loop(server: Server, scenario: Optional[Scenario] = None,
                     *, speedup: float = 1.0, lead_s: float = 0.2,
                     drain_timeout: float = 600.0,
                     feed_timeout: Optional[float] = None) -> ReplayResult:
    """Replay ``scenario`` open-loop through a wall-clock server.

    Owns the full lifecycle: ``server.start()``, paced feeding, drain,
    ``server.stop()``. Against a ``ShardedWallClockExecutor`` in hash
    routing mode the stream is fanned out once (single-pass demux) into
    one feeder per shard, each submitting directly into its shard —
    identical arrival partition to what the executor's own router would
    produce, without every submit funneling through one thread. Any
    other executor/routing gets one feeder over the merged stream (a
    sticky router's assignment depends on arrival order, so the split
    feed would change placement).

    ``speedup`` compresses trace time: an arrival at t=600s releases at
    6s wall under ``speedup=100``. Endpoint service/cold delays are NOT
    scaled — speedup multiplies offered load, which is precisely the
    sweep driver's load knob. ``lead_s`` pads the origin so the first
    arrivals aren't born late. ``feed_timeout`` bounds the feed phase
    (feeders are stopped, not abandoned, on expiry)."""
    if scenario is None:
        scenario = server.scenario
        if scenario is None:
            raise ValueError("no scenario: pass one or set "
                             "ServerConfig.scenario")
    ex = server.executor
    origin = time.monotonic() + lead_s
    injector = getattr(ex, "_injector", None)
    if injector is None:
        injector = getattr(getattr(ex, "sharded", None), "injector", None)

    if isinstance(ex, ShardedWallClockExecutor) \
            and ex._hash_route is not None:
        n = len(ex.execs)
        streams = scenario.shard_streams(n)     # demux: built for this
        feeders = [OpenLoopFeeder(ex.execs[k].submit, streams[k], origin,
                                  speedup, name=f"shard{k}",
                                  injector=injector)
                   for k in range(n)]
    elif isinstance(ex, (WallClockExecutor, ShardedWallClockExecutor)):
        feeders = [OpenLoopFeeder(ex.submit, scenario.stream(), origin,
                                  speedup, injector=injector)]
    else:
        raise TypeError(
            "replay_open_loop requires a wall-clock server "
            f"(executor='wallclock'); got {type(ex).__name__}. "
            "For virtual-clock replay use Server.run_scenario().")

    # fault plane: feeder kill/restart windows from the scenario's plan
    # (shard index modulo the actual feeder count, so a plan written for
    # a sharded replay still lands on a single-feeder run)
    plan = getattr(scenario, "faults", None)
    if plan is not None:
        for ff in getattr(plan, "feeder_faults", ()):
            feeders[ff.shard % len(feeders)].add_outage(ff.t, ff.down_s)

    t_start = time.monotonic()
    server.start()
    for f in feeders:
        f.start()
    deadline = None if feed_timeout is None else t_start + feed_timeout
    # supervise rather than sequentially join: a feeder dying at t=1s of
    # a long trace must abort the replay NOW (its shard's arrivals are
    # gone — the load measurement is already invalid), not after every
    # sibling finishes feeding
    pending = list(feeders)
    failed: Optional[OpenLoopFeeder] = None
    while pending and failed is None:
        for f in pending:
            f.join(timeout=0.05)
            if f.error is not None:
                failed = f
                break
        pending = [f for f in pending if f.is_alive()]
        if deadline is not None and time.monotonic() > deadline:
            for f in pending:
                f.stop()
            for f in pending:
                f.join()
            pending = []
    if failed is None:
        failed = next((f for f in feeders if f.error is not None), None)
    if failed is not None:
        for f in feeders:
            f.stop()
        for f in feeders:
            f.join(timeout=5.0)
        server.stop()
        raise RuntimeError(
            f"open-loop feeder {failed.name} failed after releasing "
            f"{failed.released} arrivals; replay aborted") from failed.error
    server.drain(timeout=drain_timeout)
    result = server.stop()
    wall_s = time.monotonic() - t_start

    lateness = sorted(x for f in feeders for x in f.lateness)
    return ReplayResult(result=result, lateness=lateness,
                        released=sum(f.released for f in feeders),
                        wall_s=wall_s, speedup=speedup,
                        n_feeders=len(feeders))
