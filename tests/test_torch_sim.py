"""The port's simulator against the reference's.

``repro_torch.server.SimExecutor`` is the reference's class copied as it
is, over the port's copy of the control plane. These tests drive both
packages' ``make_server(ServerConfig(...), fns=fns).run_trace(trace)``
on the same seeded traces and require the same run: every invocation's
dispatch and completion times and start type exactly, and the whole
``RunResult`` summary. Also: the golden metrics of
``tests/test_golden_metrics.py``, sim-vs-wallclock parity over
``StubEndpoint``, the ``Simulation`` / ``run_sim`` shim, the
``ServingEngine`` shim and ``launch.serve --mode sim``.
"""
import argparse
import dataclasses
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.faults as ref_faults  # noqa: E402
import repro.server as ref_server  # noqa: E402
import repro.workloads.traces as ref_traces  # noqa: E402
import repro_torch.faults as port_faults  # noqa: E402
import repro_torch.server as port_server  # noqa: E402
import repro_torch.workloads.traces as port_traces  # noqa: E402

GB = 2 ** 30
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _invocation_rows(res):
    return [(i.inv_id, i.fn_id, i.arrival, i.dispatch_time, i.exec_start,
             i.completion, i.start_type, i.overhead, i.service_time,
             i.device_id, i.charged_tau, i.retries, i.shed, i.failed)
            for i in sorted(res.invocations, key=lambda i: i.inv_id)]


def summary(res) -> dict:
    """Everything a ``RunResult`` reports, full or lean."""
    pool = res.pool
    out = {
        "policy": res.policy, "duration": res.duration,
        "completed": res.completed_count, "failed": res.failed_count,
        "shed": res.shed_count, "goodput": res.goodput(),
        "mean_latency": res.mean_latency(),
        "p50": res.p50_latency(), "p99": res.p99_latency(),
        "start_types": res.start_type_counts(),
        "mean_utilization": res.mean_utilization(),
        "pool": (pool.cold_starts, pool.warm_starts, pool.host_warm_starts,
                 pool.evictions),
        "windows": [(w.t0, w.t1, w.service, w.backlogged, w.max_gap,
                     w.bound) for w in res.fairness.windows],
        "faults": (dataclasses.asdict(res.faults)
                   if res.faults is not None else None),
    }
    if res.stats is None:
        out["invocations"] = _invocation_rows(res)
        out["inter_fn_variance"] = res.inter_fn_variance()
        out["util_samples"] = list(res.util_samples)
    else:
        s = res.stats
        out["stats"] = (s.n, s.latency_sum, s.latency_max, s.start_types,
                        s.service_by_fn, list(s._reservoir))
        out["util_integral"] = res.util_integral
    return out


def _run(pkg, traces, kind, wl, cfg, policy_kwargs, faults):
    fns, trace = traces.make_workload(kind, **wl)
    plan = None
    if faults:
        plan = faults.FaultPlan.generate(fn_ids=list(fns), **faults_kw(cfg))
    server = pkg.make_server(pkg.ServerConfig(
        policy_kwargs=policy_kwargs, faults=plan, **cfg), fns=fns)
    return trace, server.run_trace(trace)


def faults_kw(cfg):
    return dict(seed=11, horizon_s=200.0, n_devices=cfg.get("n_devices", 1),
                device_faults=2, device_down_s=10.0)


ZIPF = ("zipf", dict(n_fns=12, duration=200.0, total_rps=2.0, seed=1))
AZURE = ("azure", dict(n_fns=16, duration=300.0, trace_id=4))

# (name, workload, ServerConfig fields, policy_kwargs, with a FaultPlan)
VARIANTS = [
    ("mqfq-sticky", ZIPF, dict(policy="mqfq-sticky"), {"T": 10.0}, False),
    ("mqfq", ZIPF, dict(policy="mqfq"), {"seed": 3}, False),
    ("sfq", ZIPF, dict(policy="sfq"), {}, False),
    ("fcfs", AZURE, dict(policy="fcfs"), {}, False),
    ("sjf", AZURE, dict(policy="sjf"), {}, False),
    ("ref-mqfq-sticky-reference-layer", ZIPF,
     dict(policy="ref-mqfq-sticky", device_layer="reference"), {"T": 5.0},
     False),
    ("per-event-sampling", AZURE,
     dict(policy="mqfq-sticky", sampling="per_event"), {}, False),
    ("per-token-dispatch", ZIPF,
     dict(policy="mqfq-sticky", batch_dispatch=False), {}, False),
    ("lean", AZURE, dict(policy="mqfq-sticky", metrics="lean"), {}, False),
    ("dynamic-d", ZIPF, dict(policy="mqfq-sticky", dynamic_d=True, d=3,
                             n_devices=2), {}, False),
    ("memory-pressure", ZIPF,
     dict(policy="mqfq-sticky", capacity_bytes=int(2.5 * GB), pool_size=3,
          h2d_bw=8 * GB, mem_policy="ondemand"), {"T": 5.0}, False),
    ("device-faults", ZIPF, dict(policy="mqfq-sticky", n_devices=2, d=2,
                                 pool_size=40), {"T": 10.0}, True),
]


@pytest.mark.parametrize("name,workload,cfg,policy_kwargs,faults", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_sim_matches_reference(name, workload, cfg, policy_kwargs, faults):
    kind, wl = workload
    ref_trace, ref = _run(ref_server, ref_traces, kind, wl, cfg,
                          policy_kwargs, ref_faults if faults else None)
    port_trace, port = _run(port_server, port_traces, kind, wl, cfg,
                            policy_kwargs, port_faults if faults else None)
    assert [tuple(e) for e in port_trace] == [tuple(e) for e in ref_trace]
    assert type(port.pool).__name__ == type(ref.pool).__name__
    want, got = summary(ref), summary(port)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    if faults:
        assert want["faults"]["device_faults"] > 0
    if name == "memory-pressure":
        assert want["pool"][3] > 0      # warm-pool evictions happened
    if cfg.get("metrics") != "lean":
        assert len(want["invocations"]) == len(ref_trace)


# -- the golden metrics of tests/test_golden_metrics.py ----------------------
GOLDEN_TRACES = {
    "zipf-s0": ("zipf", dict(n_fns=12, duration=150.0, total_rps=3.0,
                             seed=0)),
    "azure-t3": ("azure", dict(n_fns=16, duration=200.0, trace_id=3)),
}
GOLDEN_POLICIES = ["mqfq-sticky", "mqfq", "sfq", "fcfs", "sjf"]
REL_TOL = 1e-9          # tests/test_golden_metrics.py's


def golden_summary(res) -> dict:
    starts = res.start_type_counts()
    return {
        "n": len(res.invocations),
        "mean_latency": res.mean_latency(),
        "p50_latency": res.p50_latency(),
        "p99_latency": res.p99_latency(),
        "cold_starts": starts.get("cold", 0),
        "warm_starts": starts.get("warm", 0),
        "host_warm_starts": starts.get("host_warm", 0),
        "inter_fn_variance": res.inter_fn_variance(),
        "mean_utilization": res.mean_utilization(),
        "fairness_max_gap": max(
            (w.max_gap for w in res.fairness.windows), default=0.0),
    }


@pytest.mark.parametrize("trace_name", sorted(GOLDEN_TRACES))
def test_golden_metrics(trace_name):
    kind, wl = GOLDEN_TRACES[trace_name]
    with open(os.path.join(GOLDEN_DIR, f"{trace_name}.json")) as f:
        want = json.load(f)
    assert sorted(want) == sorted(GOLDEN_POLICIES)
    for pol in GOLDEN_POLICIES:
        fns, trace = port_traces.make_workload(kind, **wl)
        cfg = port_server.ServerConfig(
            policy=pol, policy_kwargs={"seed": 3} if pol == "mqfq" else {},
            d=2)
        got = golden_summary(port_server.make_server(cfg, fns=fns)
                             .run_trace(trace))
        for key, expect in want[pol].items():
            if isinstance(expect, float):
                assert got[key] == pytest.approx(expect, rel=REL_TOL), \
                    (trace_name, pol, key)
            else:
                assert got[key] == expect, (trace_name, pol, key)


# -- sim-vs-wallclock parity, as tests/test_server_parity.py -----------------
N_REPEATS = 5


def _parity_fns():
    from repro_torch.workloads.spec import FunctionSpec
    taus = {"f0": 0.10, "f1": 0.17, "f2": 0.33}
    return {f: FunctionSpec(f, warm_time=t, cold_init=0.5, mem_bytes=1024,
                            demand=0.4)
            for f, t in taus.items()}


def _parity_trace(fns):
    return [port_traces.TraceEvent(0.0, f)
            for _ in range(N_REPEATS) for f in fns]


def _record(bus, log):
    @bus.on_dispatch
    def _(ev):
        log.append((ev.fn_id, ev.device_id, ev.start_type))


@pytest.mark.parametrize("T", [10.0, 0.2])  # 0.2 exercises throttling
def test_sim_wallclock_parity(T):
    from repro_torch.server import ServerConfig, StubEndpoint, make_server
    fns = _parity_fns()
    cfg = dict(policy="mqfq-sticky", policy_kwargs={"T": T, "alpha": 5.0},
               d=1, n_devices=1, capacity_bytes=1 * GB, pool_size=8)

    sim = make_server(ServerConfig(executor="sim", **cfg), fns=fns)
    sim_log = []
    _record(sim.bus, sim_log)
    sim_res = sim.run_trace(_parity_trace(fns))

    endpoints = {f: StubEndpoint(f, s, delay=None) for f, s in fns.items()}
    wc = make_server(ServerConfig(executor="wallclock", **cfg),
                     endpoints=endpoints, fns=fns)
    wc_log = []
    _record(wc.bus, wc_log)
    wc.start()
    events = _parity_trace(fns)
    wc.submit(events[0].fn_id, {"seed": 0})
    deadline = time.monotonic() + 5.0
    while not wc_log and time.monotonic() < deadline:
        time.sleep(0.002)   # first dispatch before the other arrivals
    assert wc_log, "first invocation was never dispatched"
    for ev in events[1:]:
        wc.submit(ev.fn_id, {"seed": 0})
    wc.drain(timeout=60.0)
    wc_res = wc.stop()

    n = len(fns) * N_REPEATS
    assert len(sim_res.invocations) == len(wc_res.invocations) == n
    assert all(i.done for i in wc_res.invocations)
    assert sim_log == wc_log
    assert ([i.start_type for i in sim_res.invocations]
            == [i.start_type
                for i in sorted(wc_res.invocations, key=lambda i: i.inv_id)])
    for attr in ("cold_starts", "warm_starts", "host_warm_starts"):
        assert getattr(sim_res.pool, attr) == getattr(wc_res.pool, attr)
    for f in fns:
        sim_svc = sum(i.service_time for i in sim_res.invocations
                      if i.fn_id == f)
        wc_svc = sum(i.service_time for i in wc_res.invocations
                     if i.fn_id == f)
        assert sim_svc == pytest.approx(wc_svc)
    assert sim_res.pool.cold_starts == len(fns)


# -- the deprecation shims ---------------------------------------------------
def test_run_sim_and_simulation_match_reference():
    from repro.core.policies import make_policy as ref_policy
    from repro.runtime.simulate import Simulation as RefSimulation
    from repro.runtime.simulate import run_sim as ref_run_sim
    from repro_torch.core.policies import make_policy
    from repro_torch.runtime import SimResult, Simulation, run_sim
    kw = dict(n_devices=2, d=2, pool_size=16, mem_policy="ondemand")
    kind, wl = AZURE
    fns, trace = port_traces.make_workload(kind, **wl)
    rfns, rtrace = ref_traces.make_workload(kind, **wl)
    got = run_sim(make_policy("mqfq-sticky", T=5.0), fns, trace, **kw)
    want = ref_run_sim(ref_policy("mqfq-sticky", T=5.0), rfns, rtrace, **kw)
    assert isinstance(got, SimResult)
    assert summary(got) == summary(want)
    sim = Simulation(make_policy("sjf"), fns, trace, **kw)
    ref = RefSimulation(ref_policy("sjf"), rfns, rtrace, **kw)
    assert summary(sim.run()) == summary(ref.run())


def test_serving_engine_drives_two_torch_endpoints():
    from repro.runtime.engine import ServingEngine as RefEngine
    from repro_torch.configs import get_config
    from repro_torch.core.policies import make_policy
    from repro_torch.runtime.device import TorchEndpoint
    from repro_torch.runtime.engine import ServingEngine
    from repro_torch.server import StubEndpoint
    from repro_torch.workloads.spec import FunctionSpec

    cfg = get_config("qwen3-1.7b").reduced()
    eps = {f"fn-{i}": TorchEndpoint(f"fn-{i}", cfg, seed=i, serve_seq=8,
                                    serve_batch=1, decode_steps=1,
                                    device="cpu")
           for i in range(2)}
    engine = ServingEngine(eps, make_policy("mqfq-sticky", T=5.0), d=1)
    # the reference's capacity formula: max_resident (at least 2, half
    # the endpoints by default) times the largest endpoint's weight bytes
    wb = max(int(ep.weight_bytes) for ep in eps.values())
    assert engine.server.config.capacity_bytes == 2 * wb
    stubs = {f: StubEndpoint(f, FunctionSpec(f, warm_time=0.01,
                                             cold_init=0.01,
                                             mem_bytes=int(ep.weight_bytes)))
             for f, ep in eps.items()}
    for max_resident in (None, 1, 3):
        port = ServingEngine(eps, make_policy("fcfs"),
                             max_resident=max_resident)
        ref = RefEngine(stubs, make_policy("fcfs"),
                        max_resident=max_resident)
        assert port.server.config.capacity_bytes == \
            ref.server.config.capacity_bytes
    engine.start()
    try:
        for i in range(4):
            engine.submit(f"fn-{i % 2}", {"seed": i})
        engine.drain(timeout=120.0)
    finally:
        res = engine.stop()
    assert len(engine.completed) == 4
    assert all(inv.done for inv in res.invocations)
    assert res.start_type_counts().get("cold", 0) >= 2
    assert engine.now() > 0.0


@pytest.mark.parametrize("workload", ["zipf", "azure"])
def test_serve_mode_sim_matches_reference(workload, capsys):
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    argv = ["--mode", "sim", "--workload", workload, "--duration", "200",
            "--policy", "mqfq-sticky", "--d", "2"]
    got = serve.main(argv)
    port_out = capsys.readouterr().out
    args = argparse.Namespace(
        mode="sim", policy="mqfq-sticky", T=10.0, alpha=2.0, d=2,
        dynamic_d=False, devices=1, mem_policy="prefetch_swap",
        pool_size=32, workload=workload, endpoint_shape="decode_32k",
        n_fns=24, duration=200.0, rps=1.0, trace_id=4, seed=0)
    want = ref_serve.run_sim_mode(args)
    ref_out = capsys.readouterr().out
    assert got == want
    assert port_out == ref_out
    assert json.loads(port_out) == want and want["events"] > 0
