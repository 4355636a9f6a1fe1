"""The port's sharded control plane (``repro_torch.server.shard`` and
``ShardedWallClockExecutor``) against the reference's.

A sharded sim (hash and sticky routing, 2 and 4 shards, with and without
memory pressure or a fault plan) must give the same run in both
packages: every invocation, the merged pool, fairness and devices, and
the cross-shard VT sync (epochs run, floor, lag). The routers and VT
buses must decide as the reference's; ``make_server`` must raise the
reference's error for each invalid sharded config. The sharded
wall-clock executor over ``StubEndpoint``s must drain every invocation,
each on its own shard's devices.
"""
import random
import threading

import pytest

import repro.faults as ref_faults
import repro.server as ref_server
import repro_torch.faults as port_faults
import repro_torch.server as port_server
from repro.memory.manager import GB
from test_torch_sim import summary

GRID = [("hash", 2, {}), ("hash", 4, {}), ("sticky", 2, {}),
        ("sticky", 4, {}),
        ("hash", 2, dict(capacity_bytes=int(3 * GB), pool_size=8,
                         mem_policy="ondemand")),
        ("sticky", 2, dict(dynamic_d=True, d=3)),
        ("hash", 2, dict(faults=True, pool_size=40))]


def _sharded_run(pkg, faults, traces, spec, kind, sharding, n_shards, kw):
    kw = dict(kw)
    fns = spec.function_copies(spec.DEFAULT_MIX, 16)
    if kind == "zipf":
        trace = traces.zipf_trace(fns, duration=150.0, total_rps=4.0, seed=1)
    else:
        trace = traces.azure_trace(fns, duration=200.0, trace_id=3)
    if kw.pop("faults", False):
        kw["faults"] = faults.FaultPlan.generate(
            fn_ids=list(fns), seed=7, horizon_s=150.0, n_devices=4,
            device_faults=1, device_down_s=10.0,
            endpoint_fault_frac=0.3)
    cfg = pkg.ServerConfig(policy="mqfq-sticky", policy_kwargs={"T": 10.0},
                           sharding=sharding, n_shards=n_shards,
                           n_devices=4, **{"d": 2, **kw})
    srv = pkg.make_server(cfg, fns=fns)
    return srv, srv.run_trace(iter(trace))


def _sharded_state(srv, res):
    cp = srv.control
    return {"summary": summary(res), "vt": (cp.vt_syncs, cp.vt_floor,
                                            cp.vt_max_lag,
                                            cp.vt_sync_errors),
            "assign": dict(cp.router.assign),
            "decisions": cp.policy.decisions,
            "events": srv.executor.events,
            "devices": [(d.dev_id, d.busy_time, d.tokens.current_d,
                         d.mem.bytes_uploaded, d.mem.bytes_evicted,
                         d.mem.used) for d in res.devices],
            "shard_windows": [len(t.windows)
                              for t in res.fairness.trackers]}


@pytest.mark.parametrize("kind", ["zipf", "azure"])
@pytest.mark.parametrize("sharding,n_shards,kw", GRID,
                         ids=[f"{g[0]}{g[1]}-{i}" for i, g in
                              enumerate(GRID)])
def test_sharded_sim_matches_reference(kind, sharding, n_shards, kw):
    import repro.workloads.spec as ref_spec
    import repro.workloads.traces as ref_traces
    import repro_torch.workloads.spec as port_spec
    import repro_torch.workloads.traces as port_traces
    ref_srv, ref = _sharded_run(ref_server, ref_faults, ref_traces,
                                ref_spec, kind, sharding, n_shards, kw)
    port_srv, port = _sharded_run(port_server, port_faults, port_traces,
                                  port_spec, kind, sharding, n_shards, kw)
    want, got = _sharded_state(ref_srv, ref), _sharded_state(port_srv, port)
    assert type(port_srv.control).__name__ == "ShardedControlPlane"
    for key in want:
        assert got[key] == want[key], key
    assert want["vt"][0] > 0 and want["summary"]["completed"] > 0
    assert len(want["shard_windows"]) == n_shards


def test_routers_and_vt_buses_match_reference():
    import array
    rng = random.Random(5)
    ids = [f"fn-{rng.getrandbits(32):08x}" for _ in range(300)]
    for n in (1, 2, 3, 4, 7):
        assert [port_server.hash_shard(f, n) for f in ids] == \
            [ref_server.hash_shard(f, n) for f in ids]
    ref_r, port_r = (ref_server.ShardRouter("sticky", 3, imbalance=2.0),
                     port_server.ShardRouter("sticky", 3, imbalance=2.0))
    for i in range(400):
        fn = rng.choice(ids[:40])
        backlogs = [rng.randint(0, 9) for _ in range(3)]
        idle = rng.random() < 0.5
        assert port_r.route(fn, backlogs, lambda f, k: idle) == \
            ref_r.route(fn, backlogs, lambda f, k: idle), i
    assert port_r.assign == ref_r.assign
    buses = [(ref_server.LocalVTBus(4), port_server.LocalVTBus(4)),
             (ref_server.ArrayVTBus(array.array("d", [0.0] * 4), init=True),
              port_server.ArrayVTBus(array.array("d", [0.0] * 4),
                                     init=True))]
    for rb, pb in buses:
        assert pb.floor() == rb.floor()
        for _ in range(50):
            slot, vt = rng.randrange(4), rng.uniform(0.0, 100.0)
            rb.publish(slot, vt)
            pb.publish(slot, vt)
            assert pb.floor() == rb.floor()


def _errors(pkg, spec):
    """The error each invalid sharded config raises, in order."""
    from importlib import import_module
    fns = spec.function_copies(spec.DEFAULT_MIX, 16)
    policies = import_module(f"{pkg.__name__.split('.')[0]}.core.policies")
    SC = pkg.ServerConfig
    shard_cfg = SC(sharding="hash", n_shards=2, n_devices=2)
    faults = import_module(f"{pkg.__name__.split('.')[0]}.faults")
    plan = faults.FaultPlan(device_faults=(faults.DeviceFault(1.0, 0, 5.0),))
    calls = [
        lambda: pkg.make_server(SC(sharding="modulo"), fns=fns),
        lambda: pkg.make_server(SC(sharding="none", n_shards=2), fns=fns),
        lambda: pkg.make_server(SC(sharding="hash", n_shards=3,
                                   n_devices=4), fns=fns),
        lambda: pkg.make_server(SC(sharding="hash", n_shards=2, n_devices=2,
                                   sampling="per_event"), fns=fns),
        lambda: pkg.make_server(shard_cfg, fns=fns,
                                policy=policies.make_policy("mqfq-sticky")),
        lambda: pkg.make_server(SC(sharding="hash", n_shards=4, n_devices=4,
                                   pool_size=2), fns=fns),
        lambda: pkg.make_server(SC(), fns=fns, vt_bus=pkg.LocalVTBus(1)),
        lambda: pkg.make_server(shard_cfg, fns=fns, vt_slots=[0, 1]),
        lambda: pkg.make_server(shard_cfg, fns=fns,
                                vt_bus=pkg.LocalVTBus(4), vt_slots=[1, 1]),
        lambda: pkg.make_server(shard_cfg, fns=fns,
                                vt_bus=pkg.LocalVTBus(2), vt_slots=[1, 2]),
        lambda: pkg.make_server(SC(executor="wallclock", sharding="hash",
                                   n_shards=2, n_devices=2, faults=plan),
                                endpoints={}, fns=fns),
    ]
    out = []
    for call in calls:
        with pytest.raises(ValueError) as e:
            call()
        out.append(str(e.value))
    return out


def test_sharded_config_errors_match_reference():
    import repro.workloads.spec as ref_spec
    import repro_torch.workloads.spec as port_spec
    assert _errors(port_server, port_spec) == _errors(ref_server, ref_spec)


def _stub_server(sharding, n_shards, n_fns=12):
    from repro_torch.workloads.spec import FunctionSpec
    fns = {f"f{i}": FunctionSpec(f"f{i}", warm_time=0.002, cold_init=0.01,
                                 mem_bytes=1 << 20, demand=0.2)
           for i in range(n_fns)}
    eps = {f: port_server.StubEndpoint(f, s, delay=0.002)
           for f, s in fns.items()}
    cfg = port_server.ServerConfig(
        executor="wallclock", sharding=sharding, n_shards=n_shards,
        n_devices=4, d=1, pool_size=2 * n_fns, capacity_bytes=1 << 40,
        vt_epoch=0.05, policy="mqfq-sticky", policy_kwargs={"T": 5.0})
    return port_server.make_server(cfg, endpoints=eps, fns=fns), list(fns)


@pytest.mark.parametrize("sharding,n_shards", [("hash", 2), ("hash", 4),
                                               ("sticky", 2)])
def test_sharded_wallclock_drains_stub_endpoints(sharding, n_shards):
    srv, ids = _stub_server(sharding, n_shards)
    assert isinstance(srv.executor, port_server.ShardedWallClockExecutor)
    n = 240
    srv.start()
    feeders = [threading.Thread(target=lambda t=t: [
        srv.submit(ids[i % len(ids)]) for i in range(t, n, 3)])
        for t in range(3)]
    for t in feeders:
        t.start()
    for t in feeders:
        t.join()
    srv.drain(timeout=120.0)
    res = srv.stop()
    assert len(res.invocations) == n
    assert all(i.done and not i.failed for i in res.invocations)
    assert len({i.inv_id for i in res.invocations}) == n
    assert sum(len(ex.completed) for ex in srv.executor.execs) == n
    group = srv.control._group
    for k, ex in enumerate(srv.executor.execs):
        assert {i.device_id for i in ex.completed} <= \
            set(range(k * group, (k + 1) * group))
        if sharding == "hash":
            assert {i.fn_id for i in ex.completed} == \
                {f for f in ids if port_server.hash_shard(f, n_shards) == k}
    assert srv.control.vt_syncs >= 1 and srv.control.vt_sync_errors == 0
    assert sum(res.start_type_counts().values()) == n
