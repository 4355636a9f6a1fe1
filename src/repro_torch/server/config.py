"""Declarative server configuration + factory.

``ServerConfig`` freezes every control-plane knob (policy, memory,
devices, D, warm pool) plus the executor choice; ``make_server`` wires
the pieces: policy -> ControlPlane -> executor -> Server facade.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

from repro_torch.core.policy_base import Policy
from repro_torch.memory.manager import GB
from repro_torch.workloads.spec import FunctionSpec


@dataclass(frozen=True)
class ServerConfig:
    # scheduling
    policy: str = "mqfq-sticky"
    policy_kwargs: Mapping = field(default_factory=dict)
    d: int = 2                       # per-device concurrency tokens
    dynamic_d: bool = False
    # devices / memory
    n_devices: int = 1
    mem_policy: str = "prefetch_swap"
    capacity_bytes: int = 16 * GB
    h2d_bw: float = 100 * GB         # bytes/s DMA
    # warm pool / interference / fairness
    pool_size: int = 32
    beta: float = 0.7                # oversubscription stretch (sim only)
    fairness_window: float = 30.0
    # device layer: "indexed" (heap-indexed O(log N) hot paths) or
    # "reference" (the seed's linear scans, kept in repro.memory.reference
    # for differential testing and perf baselines)
    device_layer: str = "indexed"
    # batched dispatch (paper §5 dispatcher thread): drain every freed
    # token / newly-eligible queue per control-plane pass; False runs the
    # seed's one-try_dispatch-per-call loop (bit-identical sequences)
    batch_dispatch: bool = True
    # record a per-stage wall-time breakdown of the dispatch pipeline
    # (ControlPlane.stage_ns; used by benchmarks/scale.py --stages)
    profile_stages: bool = False
    # per-event control-plane bookkeeping:
    #   "transition" — O(1)/allocation-free events: utilization is cached
    #                  and recomputed only when a dispatch/completion
    #                  changed some device's demand, the dynamic-D /
    #                  ``policy.device_parallelism`` sync runs only when a
    #                  device budget actually moved, fairness windows roll
    #                  behind a deadline check, and EventBus records are
    #                  only constructed when someone subscribed
    #   "per_event"  — the pre-PR code path (per-event device scans,
    #                  unconditional event construction), kept alive as
    #                  the differential-testing reference — same
    #                  convention as core/reference.py; see
    #                  tests/test_event_loop_equivalence.py
    sampling: str = "transition"
    # sharded control plane (repro.server.shard): partition the devices
    # into n_shards groups, each behind its own policy + scheduler index
    # + memory managers + warm pool + D-tokens + fairness tracker, with
    # cross-shard fairness via an epoch-synchronized Global_VT floor.
    #   "none"   — the monolithic ControlPlane, kept verbatim as the
    #              differential reference (and the default)
    #   "hash"   — stable crc32(fn_id) % n_shards flow partition
    #   "sticky" — locality-aware: least-backlogged shard at first
    #              arrival; rebalanced only when the flow's shard backlog
    #              exceeds shard_imbalance x the lightest shard's and the
    #              flow has no queued/in-flight work on its shard
    sharding: str = "none"
    n_shards: int = 1                # device groups (divides n_devices)
    shard_imbalance: float = 2.0     # sticky-router rebalance threshold
    # cross-shard Global_VT sync epoch: virtual seconds under the sim
    # executor, wall seconds under the wallclock executor; inter-shard
    # VT drift is bounded by one epoch's floor advance
    vt_epoch: float = 0.25
    # second-pass resident reclaim semantics: False (default) retires
    # the seed's double-counting quirk — each victim is evicted and
    # accounted exactly once (indexed device layer only). True replays
    # the seed's pre-snapshot sweep bug-for-bug (phase-1 victims
    # re-counted, see memory/manager.py) and is what the reference
    # device layer always does — it IS the seed — so the flag only
    # affects device_layer="indexed"
    strict_reclaim: bool = False
    # cold-start data plane (repro.datapath):
    #   "scalar"   — the seed's one-term cold model: cold_init is a
    #                single overhead scalar and uploads complete at the
    #                point estimate size / h2d_bw; kept verbatim as the
    #                differential reference (bit-identical to the
    #                pre-datapath plane)
    #   "pipeline" — staged cold starts (container/sandbox setup + XLA
    #                compile overlapping the host->HBM weight transfer),
    #                per-device PCIe/H2D links as contended resources
    #                (transfers share bandwidth, demand transfers
    #                preempt background prefetches, completions
    #                re-planned on entry/exit as first-class TRANSFER
    #                events) and a bounded pinned-host staging pool.
    #                Sim executor + fast event loop + indexed layer only.
    datapath: str = "scalar"
    # anticipatory weight prefetch (pipeline only): when a flow is
    # queued but not yet dispatchable and the state machine predicts
    # service, start its H2D transfer in the background through the
    # admit/acquire accounting (prefetched regions stay evictable and
    # never violate admission). False = keep-alive-only baseline: all
    # transfers happen on the dispatch critical path
    prefetch: bool = False
    prefetch_depth: int = 4          # max background prefetches/device
    staging_bytes: int = 64 * GB     # pinned-host staging pool/device
    # data plane v2 (pipeline only; defaults keep the PR-6 plane
    # bit-identical):
    #   p2p_bw      — peer-to-peer interconnect bandwidth (bytes/s per
    #                 directed device pair, repro.datapath.fabric). When
    #                 > 0, a cold start whose weights are resident in a
    #                 peer's HBM streams them over the fabric link
    #                 instead of host DRAM (source stays evictable;
    #                 eviction mid-migration falls back to the host
    #                 link, restarting from byte zero). 0 disables.
    #   chunk_bytes — chunked layer streaming: execution starts once
    #                 the first chunk_bytes of the weights land, the
    #                 residual keeps streaming demand-class on the same
    #                 link overlapped with execution. None disables
    #                 (execution waits for the full transfer).
    #   placement   — "sticky" is the PR-6 pick_device (residency
    #                 first, then least-load); "time-to-resident" bids
    #                 each free-token device by its predicted
    #                 weights-ready time (resident=0, peer=queue+bytes/
    #                 p2p_bw, host=staged link estimate), least-load
    #                 breaking ties
    p2p_bw: float = 0.0
    chunk_bytes: Optional[int] = None
    placement: str = "sticky"
    # fault injection + recovery (repro.faults, ISSUE 9). ``faults`` is
    # a fully-expanded FaultPlan (or None — the bit-identical fault-free
    # path). ``recovery=False`` keeps the naive platform as the
    # reference behavior: faults still inject, but nothing retries,
    # quarantines, or sheds — errors "complete" and a dead device stays
    # in rotation. Requires the fast event loop (sampling='transition',
    # batch_dispatch=True) and device_layer='indexed'.
    faults: Optional[object] = None  # FaultPlan
    recovery: bool = True
    retry_max: int = 3               # attempts beyond the first
    retry_backoff_s: float = 0.05    # base of the exponential backoff
    retry_deadline_s: float = 120.0  # give up (drop) past arrival + this
    quarantine_s: float = 2.0        # min bench time before re-admission
    # SLO-aware degraded mode: when predicted queueing delay exceeds
    # this, shed newest arrivals per-tenant-fairly (None = never shed)
    shed_threshold_s: Optional[float] = None
    # executor: "sim" (virtual clock) or "wallclock" (threads + JAX)
    executor: str = "sim"
    # metrics: "full" records every invocation + utilization sample;
    # "lean" streams aggregates (constant memory at any trace length)
    metrics: str = "full"
    # named workload scenario (repro.workloads.scenarios): when set and
    # fns= is omitted, the server builds the scenario's function mix;
    # ``run_scenario()`` replays its stream on the virtual clock (sim),
    # ``replay_open_loop()`` paces it in real time (wallclock)
    scenario: str = ""
    scenario_kwargs: Mapping = field(default_factory=dict)


def specs_from_endpoints(endpoints, *, demand: float = 0.5
                         ) -> Dict[str, FunctionSpec]:
    """Derive control-plane FunctionSpecs from live endpoints: the memory
    manager accounts real weight bytes; warm/cold times are only used by
    the sim executor, so nominal values suffice here."""
    return {
        fn_id: FunctionSpec(fn_id, warm_time=1.0, cold_init=5.0,
                            mem_bytes=max(int(ep.weight_bytes), 1),
                            demand=demand, kind="endpoint")
        for fn_id, ep in endpoints.items()}


def _adopt_scenario_faults(config, scenario, validate):
    """A chaos scenario carries its seeded FaultPlan; adopt it unless the
    caller pinned one explicitly (explicit config wins)."""
    plan = getattr(scenario, "faults", None)
    if plan is None or config.faults is not None:
        return config
    from dataclasses import replace
    config = replace(config, faults=plan)
    validate(config)
    return config


def make_server(config: ServerConfig, *,
                fns: Optional[Dict[str, FunctionSpec]] = None,
                endpoints: Optional[dict] = None,
                policy: Optional[Policy] = None,
                vt_bus=None, vt_slots=None):
    """Build a Server from a frozen config.

    - ``executor="sim"``: requires ``fns``; drive it with
      ``server.run_trace(trace)``.
    - ``executor="wallclock"``: requires ``endpoints`` (``fns`` derived
      from their weight bytes unless given); drive it with
      ``start() / submit() / drain() / stop()``.
    - ``policy``: optional pre-built Policy instance (tests/ablations);
      otherwise built from ``config.policy`` + ``config.policy_kwargs``.
      A sharded plane builds one policy *per shard* from the config, so
      a pre-built instance is rejected there.
    - ``vt_bus`` / ``vt_slots``: external cross-shard VT snapshot for
      process-per-shard deployments (see ``repro.server.shard``); only
      meaningful with ``sharding != "none"``.
    """
    from repro_torch.core.policies import make_policy
    from repro_torch.server.control import ControlPlane
    from repro_torch.server.events import EventBus
    from repro_torch.server.executors import (Server, ShardedWallClockExecutor,
                                        SimExecutor, WallClockExecutor)
    from repro_torch.server.shard import ShardedControlPlane

    if config.sharding not in ("none", "hash", "sticky"):
        raise ValueError(f"unknown sharding {config.sharding!r}; "
                         f"expected 'none', 'hash' or 'sticky'")
    if config.datapath not in ("scalar", "pipeline"):
        raise ValueError(f"unknown datapath {config.datapath!r}; "
                         f"expected 'scalar' or 'pipeline'")
    if config.datapath == "pipeline":
        if config.executor != "sim":
            raise ValueError(
                "datapath='pipeline' is sim-only: the wallclock executor "
                "moves real bytes, so modeled link contention does not "
                "apply there")
        if config.sampling != "transition" or not config.batch_dispatch:
            raise ValueError(
                "datapath='pipeline' requires the fast event loop "
                "(sampling='transition', batch_dispatch=True): the "
                "per_event/per-token loops are pre-datapath differential "
                "references and carry no TRANSFER events")
    if config.prefetch and config.datapath != "pipeline":
        raise ValueError(
            "prefetch=True requires datapath='pipeline': the scalar "
            "plane has no background transfer machinery to prefetch on")
    if config.placement not in ("sticky", "time-to-resident"):
        raise ValueError(f"unknown placement {config.placement!r}; "
                         f"expected 'sticky' or 'time-to-resident'")
    if config.datapath != "pipeline":
        if config.p2p_bw:
            raise ValueError(
                "p2p_bw > 0 requires datapath='pipeline': the scalar "
                "plane has no transfer fabric to migrate weights over")
        if config.chunk_bytes is not None:
            raise ValueError(
                "chunk_bytes requires datapath='pipeline': the scalar "
                "plane has no chunked transfers to overlap")
        if config.placement != "sticky":
            raise ValueError(
                "placement='time-to-resident' requires "
                "datapath='pipeline': its bids are link-model transfer "
                "estimates")
    if config.chunk_bytes is not None and config.chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be a positive byte count")
    if config.p2p_bw < 0:
        raise ValueError("p2p_bw must be >= 0 (bytes/s; 0 disables)")

    def _validate_faults(cfg):
        plan = cfg.faults
        if plan is None:
            return
        if cfg.sampling != "transition" or not cfg.batch_dispatch:
            raise ValueError(
                "faults= requires the fast event loop "
                "(sampling='transition', batch_dispatch=True): the "
                "per_event/per-token loops are pre-fault differential "
                "references and carry no fault events")
        if cfg.device_layer != "indexed":
            raise ValueError(
                "faults= requires device_layer='indexed': the reference "
                "layer is the pre-fault differential baseline")
        bad = sorted({f.dev_id for f in getattr(plan, "device_faults", ())
                      if f.dev_id >= cfg.n_devices}
                     | {f.dev_id for f in getattr(plan, "transfer_faults", ())
                        if f.dev_id >= cfg.n_devices})
        if bad:
            raise ValueError(
                f"fault plan targets device ids {bad} but the server has "
                f"n_devices={cfg.n_devices}; generate the plan (or the "
                f"chaos scenario) with the server's device count")
        if getattr(plan, "transfer_faults", ()) \
                and cfg.datapath != "pipeline":
            raise ValueError(
                "transfer faults require datapath='pipeline': the "
                "scalar plane has no in-flight transfers to abort")
        if cfg.executor == "wallclock" and cfg.sharding != "none" \
                and (getattr(plan, "device_faults", ())
                     or getattr(plan, "endpoint_faults", ())
                     or getattr(plan, "transfer_faults", ())):
            raise ValueError(
                "sharded wallclock supports feeder faults only; "
                "device/endpoint/transfer faults need the monolithic "
                "wallclock executor or the (sharded or monolithic) sim")

    _validate_faults(config)
    sharded = config.sharding != "none"
    if not sharded and config.n_shards != 1:
        raise ValueError("n_shards > 1 requires sharding='hash' or "
                         "'sticky' (sharding='none' is the monolithic "
                         "reference plane)")
    if not sharded and (vt_bus is not None or vt_slots is not None):
        raise ValueError("vt_bus/vt_slots require sharding='hash' or "
                         "'sticky': the monolithic plane runs no "
                         "cross-shard VT sync, so the bus would be "
                         "silently ignored")
    if sharded and policy is not None:
        raise ValueError("a sharded plane builds one policy per shard "
                         "from config.policy/policy_kwargs; a pre-built "
                         "policy= instance cannot be shared")
    if policy is None and not sharded:
        policy = make_policy(config.policy, **dict(config.policy_kwargs))
    bus = EventBus()

    def build_control():
        if sharded:
            return ShardedControlPlane(fns, config, bus, vt_bus=vt_bus,
                                       vt_slots=vt_slots)
        return ControlPlane(policy, fns, config, bus)

    scenario = None
    if config.executor == "sim":
        if fns is None and config.scenario:
            from repro_torch.workloads.scenarios import make_scenario
            scenario = make_scenario(config.scenario,
                                     **dict(config.scenario_kwargs))
            fns = scenario.fns
            config = _adopt_scenario_faults(config, scenario,
                                            _validate_faults)
        if fns is None:
            raise ValueError("sim executor requires fns= (or scenario=)")
        control = build_control()
        executor = SimExecutor(control, config)
    elif config.executor == "wallclock":
        if config.scenario:
            # historically rejected ("drive it via submit()"); now the
            # open-loop replay harness (repro.replay) is the wallclock
            # consumer of a configured scenario: fns come from the mix,
            # server.replay_open_loop() paces its stream. Endpoints are
            # still the caller's job — one per scenario function.
            from repro_torch.workloads.scenarios import make_scenario
            scenario = make_scenario(config.scenario,
                                     **dict(config.scenario_kwargs))
            if fns is None:
                fns = scenario.fns
            config = _adopt_scenario_faults(config, scenario,
                                            _validate_faults)
        if endpoints is None:
            raise ValueError("wallclock executor requires endpoints=")
        if fns is None:
            fns = specs_from_endpoints(endpoints)
        control = build_control()
        injector = getattr(control, "injector", None)
        if injector is not None and injector.plan.endpoint_faults:
            # count-triggered endpoint faults inject from inside the
            # endpoint call, sharing the control plane's injector so the
            # per-fn attempt counters match the sim's realize-time path
            from repro_torch.faults import FaultyEndpoint
            endpoints = {fn: FaultyEndpoint(ep, injector)
                         for fn, ep in endpoints.items()}
        if sharded:
            executor = ShardedWallClockExecutor(control, endpoints, config)
        else:
            executor = WallClockExecutor(control, endpoints, config)
    else:
        raise ValueError(f"unknown executor {config.executor!r}")
    server = Server(config, control, executor, bus)
    server.scenario = scenario
    return server
