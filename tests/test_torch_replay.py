"""The port's open-loop replay (``repro_torch.replay``,
``Server.replay_open_loop``) through its wall-clock executors.

Wall-clock runs vary from run to run, so these tests hold ordering and
completeness, not timing: every arrival of the scenario is released,
none early (lateness is never negative), each becomes one completed
invocation, and a hash-sharded replay feeds each shard exactly the
arrivals the reference's ``Scenario.shard_streams`` routes to it. The
endpoints are ``StubEndpoint``s, and in one test reduced qwen3-1.7b and
xlstm-350m ``TorchEndpoint``s on the CPU.
"""
import collections

import pytest

from repro.workloads import scenarios as ref_sc
from repro_torch.replay import OpenLoopFeeder, ReplayResult, replay_open_loop
from repro_torch.server import (ServerConfig, ShardedWallClockExecutor,
                                StubEndpoint, WallClockExecutor,
                                hash_shard, make_server)
from repro_torch.workloads.scenarios import make_scenario

# the chip_smoke.py replay's scenario over 10 minutes of trace: 6
# functions over 2 tenants, 34 arrivals (the script replays 5 minutes,
# 20 arrivals, of the same scenario)
REPLAY = dict(n_fns=7, minutes=10, seed=24, mean_rpm=3.0)


def _stubs(sc, delay=0.001, cold=0.005):
    return {f: StubEndpoint(f, s, delay=delay, cold_delay=cold)
            for f, s in sc.fns.items()}


def _check_complete(rr, sc):
    total = sum(1 for _ in sc.stream())
    assert rr.released == total == rr.result.completed_count
    invs = rr.result.invocations
    assert len(invs) == total and len({i.inv_id for i in invs}) == total
    assert all(i.done and not i.failed for i in invs)
    assert len(rr.lateness) == total and min(rr.lateness) >= 0.0
    assert rr.lateness == sorted(rr.lateness)
    assert all(i.lateness is not None and i.lateness >= 0.0 for i in invs)
    assert all(i.exec_start >= i.arrival for i in invs)
    want = collections.Counter(e.fn_id for e in sc.stream())
    assert collections.Counter(i.fn_id for i in invs) == want
    return total


def test_monolithic_replay_releases_and_completes_every_arrival():
    sc = make_scenario("azure-replay", **REPLAY)
    srv = make_server(ServerConfig(executor="wallclock", policy="mqfq-sticky",
                                   d=2, n_devices=2),
                      fns=sc.fns, endpoints=_stubs(sc))
    assert isinstance(srv.executor, WallClockExecutor)
    rr = srv.replay_open_loop(sc, speedup=600.0)
    assert isinstance(rr, ReplayResult) and rr.n_feeders == 1
    total = _check_complete(rr, sc)
    assert total == 34 and rr.throughput() > 0.0
    starts = rr.result.start_type_counts()
    assert starts.get("cold", 0) >= 1 and sum(starts.values()) == total
    tenants = rr.per_tenant_quantiles(sc, slo_s=10.0)
    assert set(tenants) == set(sc.tenants.values()) and len(tenants) == 2
    assert sum(int(r["n"]) for r in tenants.values()) == total
    assert 0.0 <= rr.lateness_quantile(0.99) <= rr.max_lateness


@pytest.mark.parametrize("n_shards", [2, 4])
def test_hash_sharded_replay_feeds_each_shard_its_partition(n_shards):
    sc = make_scenario("azure-replay", n_fns=12, minutes=4, seed=4,
                       mean_rpm=3.0)
    cfg = ServerConfig(executor="wallclock", policy="mqfq-sticky", d=2,
                       n_devices=4, sharding="hash", n_shards=n_shards)
    srv = make_server(cfg, fns=sc.fns, endpoints=_stubs(sc))
    assert isinstance(srv.executor, ShardedWallClockExecutor)
    rr = replay_open_loop(srv, sc, speedup=240.0)
    assert rr.n_feeders == n_shards
    _check_complete(rr, sc)
    # each shard's executor completed exactly the arrivals the
    # reference's fan-out routes to it, in its order of arrival
    ref = ref_sc.make_scenario("azure-replay", n_fns=12, minutes=4, seed=4,
                               mean_rpm=3.0)
    for k, (ex, stream) in enumerate(zip(srv.executor.execs,
                                         ref.shard_streams(n_shards))):
        want = [e.fn_id for e in stream]
        got = [i.fn_id for i in sorted(ex.completed,
                                       key=lambda i: i.inv_id)]
        assert collections.Counter(got) == collections.Counter(want), k
        assert all(hash_shard(f, n_shards) == k for f in got)
    per_shard = rr.per_shard_quantiles(n_shards)
    assert sum(int(r["n"]) for r in per_shard.values()) == rr.released


def test_sticky_sharded_replay_uses_one_feeder():
    sc = make_scenario("azure-replay", **REPLAY)
    cfg = ServerConfig(executor="wallclock", policy="mqfq-sticky", d=2,
                       n_devices=2, sharding="sticky", n_shards=2)
    rr = make_server(cfg, fns=sc.fns,
                     endpoints=_stubs(sc)).replay_open_loop(sc,
                                                            speedup=600.0)
    assert rr.n_feeders == 1
    _check_complete(rr, sc)


def test_feeder_faults_delay_but_lose_nothing():
    """A chaos plan's feeder kill/restart windows: the feeder stops and
    then releases its backlog; every arrival still completes."""
    from repro_torch.faults import FaultPlan
    sc = make_scenario("azure-replay", **REPLAY)
    sc.faults = FaultPlan.generate(seed=3, horizon_s=600.0, n_devices=2,
                                   fn_ids=list(sc.fns), feeder_faults=2,
                                   n_feeders=2, feeder_down_s=60.0)
    assert len(sc.faults.feeder_faults) == 2
    cfg = ServerConfig(executor="wallclock", policy="mqfq-sticky", d=2,
                       n_devices=2, sharding="hash", n_shards=2,
                       faults=sc.faults)
    srv = make_server(cfg, fns=sc.fns, endpoints=_stubs(sc))
    rr = srv.replay_open_loop(sc, speedup=600.0)
    _check_complete(rr, sc)
    assert srv.control.injector.feeder_kills == 2


def test_replay_refuses_the_sim_executor_and_a_missing_scenario():
    from repro.server import ServerConfig as RefConfig
    from repro.server import make_server as ref_make
    sc = make_scenario("azure-replay", n_fns=4, minutes=2, seed=0)
    ref = ref_sc.make_scenario("azure-replay", n_fns=4, minutes=2, seed=0)
    msgs = []
    for srv, s in ((ref_make(RefConfig(policy="mqfq-sticky"), fns=ref.fns),
                    ref),
                   (make_server(ServerConfig(policy="mqfq-sticky"),
                                fns=sc.fns), sc)):
        with pytest.raises(TypeError, match="wall-clock") as e:
            srv.replay_open_loop(s)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    srv = make_server(ServerConfig(executor="wallclock"), fns=sc.fns,
                      endpoints=_stubs(sc))
    with pytest.raises(ValueError, match="no scenario"):
        srv.replay_open_loop()
    with pytest.raises(ValueError, match="speedup"):
        OpenLoopFeeder(lambda f: None, iter([]), 0.0, speedup=0.0)


def test_wallclock_server_adopts_a_configured_scenario():
    """``ServerConfig(scenario=...)`` with the wall-clock executor: the
    server carries the scenario, its fns come from the mix, and
    ``replay_open_loop()`` with no argument replays it."""
    cfg = ServerConfig(executor="wallclock", policy="mqfq-sticky", d=2,
                       n_devices=2, scenario="azure-replay",
                       scenario_kwargs=REPLAY)
    sc = make_scenario("azure-replay", **REPLAY)
    srv = make_server(cfg, endpoints=_stubs(sc))
    assert srv.scenario is not None and set(srv.control.fns) == set(sc.fns)
    _check_complete(srv.replay_open_loop(speedup=600.0), srv.scenario)


def test_replay_drives_reduced_torch_endpoints_on_cpu():
    """The chip_smoke.py replay in miniature: the six functions of its
    scenario on reduced qwen3-1.7b (one with ``kv_quant``) and
    xlstm-350m endpoints on the CPU, admission counting their real
    weight bytes, a device capacity of two of them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.runtime.device import TorchEndpoint
    from repro_torch.server import specs_from_endpoints
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    sc = make_scenario("azure-replay", **REPLAY)
    qwen = get_config("qwen3-1.7b").reduced()
    xlstm = get_config("xlstm-350m").reduced()
    cfgs = [qwen, dataclasses.replace(qwen, kv_quant=True), xlstm,
            qwen, xlstm, xlstm]
    eps = {f: TorchEndpoint(f, c, seed=i, serve_seq=16, serve_batch=1,
                            decode_steps=2, device="cpu")
           for i, (f, c) in enumerate(zip(sorted(sc.fns), cfgs))}
    cap = 2 * max(ep.weight_bytes for ep in eps.values())
    srv = make_server(ServerConfig(executor="wallclock",
                                   policy="mqfq-sticky", d=2,
                                   capacity_bytes=cap),
                      fns=specs_from_endpoints(eps), endpoints=eps)
    rr = srv.replay_open_loop(sc, speedup=300.0)
    _check_complete(rr, sc)
    assert all(ep.compiled and ep.uploads >= 1 for ep in eps.values())
    assert rr.result.start_type_counts().get("cold", 0) >= len(eps)
