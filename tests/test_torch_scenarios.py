"""The port's scenario library and Azure loader
(``repro_torch.workloads.scenarios``, ``azure_loader``) against the
reference's.

Every registered scenario, the chaos variants included, must build the
same functions (each ``FunctionSpec`` field and its cold-start stages),
the same first events, the same per-shard fan-out and the same fault
plan in both packages, and ``Server.run_scenario`` must give the same
run per invocation at small sizes. The Azure loader must read the same
rows and stream the same arrivals on its seeded synthetic fallback and
from a CSV written here, by path and through ``REPRO_AZURE_TRACE``.
"""
import dataclasses
import itertools

import pytest

import repro.server as ref_server
import repro_torch.server as port_server
from repro.workloads import azure_loader as ref_az
from repro.workloads import scenarios as ref_sc
from repro_torch.workloads import azure_loader as port_az
from repro_torch.workloads import scenarios as port_sc
from test_torch_sim import summary

NAMES = sorted(ref_sc.SCENARIOS)


def _fns(sc):
    return {f: dataclasses.asdict(s) for f, s in sc.fns.items()}


def _events(stream, n=None):
    return [(e.time, e.fn_id) for e in itertools.islice(stream, n)]


def test_registry_matches_reference():
    assert sorted(port_sc.SCENARIOS) == NAMES
    assert {"flash-crowd", "diurnal", "tenant-hog", "cold-start-storm",
            "azure-longtail", "azure-replay", "chaos-azure-longtail",
            "chaos-cold-start-storm", "chaos-flash-crowd"} <= set(NAMES)
    msgs = []
    for mod in (ref_sc, port_sc):
        with pytest.raises(ValueError, match="unknown scenario") as e:
            mod.make_scenario("nope")
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("name", NAMES)
def test_scenario_builds_as_reference(name):
    kw = dict(max_events=400, seed=4)
    ref, port = ref_sc.make_scenario(name, **kw), \
        port_sc.make_scenario(name, **kw)
    assert type(port).__name__ == "Scenario"
    assert (port.name, port.description, port.max_events, port.tenants) == \
        (ref.name, ref.description, ref.max_events, ref.tenants)
    assert _fns(port) == _fns(ref)
    got, want = _events(port.stream()), _events(ref.stream())
    assert got == want and len(want) > 0
    for f in list(ref.fns)[:8]:
        assert port.tenant_of(f) == ref.tenant_of(f)
    for n in (2, 3):
        for mode in ("demux", "filter"):
            assert [_events(s) for s in port.shard_streams(n, mode=mode)] \
                == [_events(s) for s in ref.shard_streams(n, mode=mode)]
    if name.startswith("chaos-"):
        assert port.faults and dataclasses.asdict(port.faults) == \
            dataclasses.asdict(ref.faults)
    else:
        assert port.faults is None and ref.faults is None


# small sizes for Server.run_scenario: (scenario kwargs, ServerConfig)
RUNS = {
    "flash-crowd": (dict(n_fns=10, duration=300.0), {}),
    "diurnal": (dict(n_fns=10, duration=400.0), {}),
    "tenant-hog": (dict(n_fns=10, duration=300.0), {}),
    "cold-start-storm": (dict(n_fns=16, duration=480.0,
                              spec_profile="llm"), dict(pool_size=40)),
    "azure-longtail": (dict(n_fns=30, total_rps=2.0, max_events=600), {}),
    "azure-replay": (dict(n_fns=12, minutes=10, seed=3, mean_rpm=3.0), {}),
    "chaos-azure-longtail": (dict(n_fns=30, max_events=600, seed=11,
                                  chaos_seed=11, horizon_s=60.0,
                                  n_devices=4, device_faults=1,
                                  endpoint_fault_frac=0.3),
                             dict(n_devices=4, pool_size=160)),
    "chaos-cold-start-storm": (dict(n_fns=16, duration=480.0,
                                    spec_profile="llm", chaos_seed=2,
                                    n_devices=4),
                               dict(n_devices=4, pool_size=80,
                                    datapath="pipeline", prefetch=True)),
    "chaos-flash-crowd": (dict(n_fns=10, duration=300.0, chaos_seed=3,
                               n_devices=4),
                          dict(n_devices=4, pool_size=80)),
}


def test_run_sizes_cover_every_scenario():
    assert sorted(RUNS) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_run_scenario_matches_reference(name):
    sc_kw, cfg_kw = RUNS[name]
    runs = []
    for pkg in (ref_server, port_server):
        cfg = pkg.ServerConfig(policy="mqfq-sticky",
                               policy_kwargs={"T": 10.0}, d=2,
                               scenario=name, scenario_kwargs=sc_kw,
                               **cfg_kw)
        srv = pkg.make_server(cfg)
        assert srv.scenario is not None
        res = srv.run_scenario()
        runs.append((srv, res))
    (ref_srv, ref), (port_srv, port) = runs
    want, got = summary(ref), summary(port)
    for key in want:
        assert got[key] == want[key], key
    assert want["completed"] > 0
    # a chaos scenario's plan is adopted by both servers
    assert (port_srv.config.faults is None) == (ref_srv.config.faults is None)
    if name.startswith("chaos-"):
        assert dataclasses.asdict(port_srv.config.faults) == \
            dataclasses.asdict(ref_srv.config.faults)
        assert want["faults"]["arrivals"] > 0


def test_scenario_server_errors_match_reference():
    msgs = []
    for pkg in (ref_server, port_server):
        out = []
        for call in (
                lambda: pkg.make_server(pkg.ServerConfig()),
                lambda: pkg.make_server(pkg.ServerConfig(
                    scenario="chaos-flash-crowd",
                    scenario_kwargs={"n_fns": 4, "n_devices": 4}))):
            with pytest.raises(ValueError) as e:
                call()
            out.append(str(e.value))
        srv = pkg.make_server(pkg.ServerConfig(), fns=_copies(pkg))
        with pytest.raises(ValueError) as e:
            srv.run_scenario()
        out.append(str(e.value))
        msgs.append(out)
    assert msgs[1] == msgs[0]


def _copies(pkg):
    """Two copies of the paper's mix from ``pkg``'s package."""
    from importlib import import_module
    spec = import_module(f"{pkg.__name__.split('.')[0]}.workloads.spec")
    return spec.function_copies(spec.DEFAULT_MIX, 2)


# -- the Azure loader -------------------------------------------------------

AZURE_CSV = """HashOwner,HashApp,HashFunction,Trigger,1,2,3,4,5
ownerA,app1,fn1,http,3,0,2,0,1
ownerA,app1,fn2,timer,0,0,0,0,0
ownerB,app2,fn3,http,1,1,1,1,1
badrow,app,fn,http,1,x,1,1,1
ownerC,app3,fn4,queue,10,0,0,0,7
ownerC,app3,fn5,http,0,4,0,0,9
"""


def _rows(rows):
    return [(r.owner, r.app, r.func, r.trigger, list(r.counts))
            for r in rows]


@pytest.mark.parametrize("kw", [dict(n_fns=16, minutes=20, seed=3),
                                dict(n_fns=7, minutes=10, seed=24,
                                     mean_rpm=3.0),
                                dict(n_fns=40, minutes=60, seed=0,
                                     mean_rpm=0.6)])
def test_synthetic_fallback_matches_reference(kw, monkeypatch):
    monkeypatch.delenv("REPRO_AZURE_TRACE", raising=False)
    sc_kw = dict(kw)
    n = sc_kw.pop("n_fns")
    assert _rows(port_az.synthetic_azure_rows(n, **sc_kw)) == \
        _rows(ref_az.synthetic_azure_rows(n, **sc_kw))
    for extra in ({}, dict(p_sample=0.5), dict(mem_scale=2.0,
                                               max_events=50)):
        ref = ref_az.load_azure_scenario(**kw, **extra)
        port = port_az.load_azure_scenario(**kw, **extra)
        assert "synthetic-fallback" in port.description
        assert port.description == ref.description
        assert port.tenants == ref.tenants and _fns(port) == _fns(ref)
        assert _events(port.stream()) == _events(ref.stream())


def test_csv_loader_matches_reference(tmp_path, monkeypatch):
    p = tmp_path / "invocations.csv"
    p.write_text(AZURE_CSV)
    for minutes in (None, 2, 5):
        assert _rows(port_az.iter_azure_rows(str(p), minutes=minutes)) == \
            _rows(ref_az.iter_azure_rows(str(p), minutes=minutes))
    for kw in (dict(n_fns=8, minutes=5), dict(n_fns=2, minutes=5, seed=3),
               dict(n_fns=8, minutes=3, min_total=4, p_sample=0.5)):
        ref = ref_az.load_azure_scenario(str(p), **kw)
        port = port_az.load_azure_scenario(str(p), **kw)
        assert port.description == ref.description
        assert port.tenants == ref.tenants and _fns(port) == _fns(ref)
        assert _events(port.stream()) == _events(ref.stream())
    # the registered scenario reads the CSV named by REPRO_AZURE_TRACE
    monkeypatch.setenv(port_az.AZURE_TRACE_ENV, str(p))
    assert port_az.AZURE_TRACE_ENV == ref_az.AZURE_TRACE_ENV
    ref = ref_sc.make_scenario("azure-replay", n_fns=8, minutes=5)
    port = port_sc.make_scenario("azure-replay", n_fns=8, minutes=5)
    assert "invocations.csv" in port.description
    assert _events(port.stream()) == _events(ref.stream())
    assert len(_events(port.stream())) == 6 + 5 + 17 + 13
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b\n1,2\n")
    for mod in (ref_az, port_az):
        with pytest.raises(ValueError, match="not an Azure"):
            list(mod.iter_azure_rows(str(bad)))


def test_counts_stream_matches_reference():
    from repro.workloads.traces import fn_rng as ref_rng
    from repro_torch.workloads.traces import fn_rng as port_rng
    counts = [3, 0, 5, 1, 0, 2, 40]
    for p in (1.0, 0.25):
        assert _events(port_az.counts_stream("f", counts, port_rng(0, "f"),
                                             p_sample=p)) == \
            _events(ref_az.counts_stream("f", counts, ref_rng(0, "f"),
                                         p_sample=p))
