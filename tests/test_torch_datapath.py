"""The port's cold-start data plane (``repro_torch.datapath``) against the
reference's (``repro.datapath``).

The sim on ``datapath="pipeline"`` must give the same run in both
packages, per invocation and in the data plane's own counters, over a
small grid: prefetch off and on, chunked streaming, a peer-to-peer
fabric and a plan with transfer faults. The shared link (the cached
``SharedLink`` and the scanning ``ReferenceSharedLink``) must plan the
same ETAs and completions as the reference's over seeded link programs,
including the program at seed 41262 whose drain plans an ETA before the
time already reached (reference behaviour, ROADMAP.md section 3).
"""
import random

import pytest

import repro.datapath.link as ref_link
import repro.faults as ref_faults
import repro.server as ref_server
import repro_torch.datapath.link as port_link
import repro_torch.faults as port_faults
import repro_torch.server as port_server
from repro.memory.manager import GB
from test_torch_sim import summary


def _datapath_counters(srv):
    out = []
    for dev in srv.control.devices:
        dp = dev.datapath
        out.append((dp.transfers_completed, dp.demand_transfers,
                    dp.prefetches_started, dp.prefetches_cancelled,
                    sorted(dp.transfers), dp.staging.used))
    fab = getattr(srv.control, "fabric", None)
    if fab is not None:
        out.append(("fabric", fab.migrations_completed,
                    sorted(fab.links)))
    return out


STORM = dict(n_fns=12, duration=480.0, wave_period=120.0, wave_width=4.0,
             participation=0.9, seed=3, spec_profile="llm",
             llm_h2d_bw=16 * GB)

# (name, ServerConfig fields besides the pipeline's, transfer faults)
GRID = [
    ("keep-alive", dict(prefetch=False), 0),
    ("prefetch", dict(prefetch=True), 0),
    ("chunked", dict(prefetch=True, chunk_bytes=1 * GB), 0),
    ("p2p-fabric", dict(prefetch=True, n_devices=3, p2p_bw=96 * GB,
                        capacity_bytes=40 * GB), 0),
    ("time-to-resident", dict(prefetch=True, n_devices=2,
                              p2p_bw=64 * GB, chunk_bytes=2 * GB,
                              placement="time-to-resident",
                              capacity_bytes=40 * GB), 0),
    ("transfer-faults", dict(prefetch=True, n_devices=2,
                             capacity_bytes=40 * GB), 3),
]


def _pipeline_run(pkg, faults, cfg, n_transfer_faults):
    kw = dict(policy="mqfq-sticky", policy_kwargs={"T": 10.0, "alpha": 0.3},
              d=1, n_devices=1, capacity_bytes=64 * GB, h2d_bw=16 * GB,
              pool_size=32, datapath="pipeline",
              scenario="cold-start-storm", scenario_kwargs=STORM)
    kw.update(cfg)
    if n_transfer_faults:
        kw["faults"] = faults.FaultPlan.generate(
            fn_ids=[f"llm-{i}" for i in range(STORM["n_fns"])], seed=5,
            horizon_s=STORM["duration"], n_devices=kw["n_devices"],
            transfer_faults=n_transfer_faults)
    srv = pkg.make_server(pkg.ServerConfig(**kw))
    return srv, srv.run_scenario()


@pytest.mark.parametrize("name,cfg,n_transfer_faults", GRID,
                         ids=[g[0] for g in GRID])
def test_pipeline_sim_matches_reference(name, cfg, n_transfer_faults):
    ref_srv, ref = _pipeline_run(ref_server, ref_faults, cfg,
                                 n_transfer_faults)
    port_srv, port = _pipeline_run(port_server, port_faults, cfg,
                                   n_transfer_faults)
    want, got = summary(ref), summary(port)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert _datapath_counters(port_srv) == _datapath_counters(ref_srv)
    assert want["completed"] > 0 and len(want["invocations"]) > 0
    if cfg.get("prefetch"):
        assert sum(c[2] for c in _datapath_counters(ref_srv)
                   if c[0] != "fabric") > 0
    if n_transfer_faults:
        assert want["faults"]["transfer_aborts"] > 0
    if cfg.get("p2p_bw") and name == "p2p-fabric":
        assert ref_srv.control.fabric.migrations_completed > 0


def test_make_server_validates_the_pipeline_as_the_reference():
    """Each invalid pipeline config raises the reference's error, and the
    valid ones build in both packages."""
    from repro.workloads.spec import DEFAULT_MIX, function_copies
    from repro_torch.workloads.spec import function_copies as port_copies
    bad = [dict(datapath="turbo"), dict(datapath="pipeline",
                                        sampling="per_event"),
           dict(datapath="pipeline", batch_dispatch=False),
           dict(prefetch=True), dict(p2p_bw=GB), dict(chunk_bytes=GB),
           dict(placement="time-to-resident"),
           dict(datapath="pipeline", chunk_bytes=0),
           dict(datapath="pipeline", device_layer="reference")]
    for cfg in bad:
        with pytest.raises(ValueError) as want:
            ref_server.make_server(ref_server.ServerConfig(**cfg),
                                   fns=function_copies(DEFAULT_MIX, 2))
        with pytest.raises(ValueError) as got:
            port_server.make_server(port_server.ServerConfig(**cfg),
                                    fns=port_copies(DEFAULT_MIX, 2))
        assert str(got.value) == str(want.value), cfg
    for pkg in (ref_server, port_server):
        with pytest.raises(ValueError, match="sim-only"):
            pkg.make_server(pkg.ServerConfig(datapath="pipeline",
                                             executor="wallclock"),
                            endpoints={})
    srv = port_server.make_server(
        port_server.ServerConfig(datapath="pipeline", prefetch=True),
        fns=port_copies(DEFAULT_MIX, 2))
    assert all(d.datapath is not None for d in srv.control.devices)


# -- the shared link: seeded programs through both packages ------------------

def _link_program(link, rng, steps=60, bw=10.0):
    """One random mutation program (tests/test_fabric.py's conservation
    fuzz) through one package's cached and scanning links, then a drain
    at the planned event times; returns every ETA, remaining-bytes
    state, milestone and completion it saw, and each drain step's (eta,
    time reached) pair. Nothing is asserted here: the reference's own
    checks live in tests/test_fabric.py."""
    fast, scan = link.SharedLink(bw), link.ReferenceSharedLink(bw)
    pairs, log, drain = {}, [], []
    now, nid = 0.0, 0

    def state():
        return (fast.next_eta(), scan.next_eta(), fast._last,
                tuple((f, tf.remaining, tf.eta, tf.chunk_eta, tr.remaining,
                       tr.eta, tr.chunk_eta)
                      for f, (tf, tr) in sorted(pairs.items())))

    for _ in range(steps):
        now += rng.random()
        op = rng.choice("aaamrkcp")
        if op == "a":
            nb = rng.randint(1, 60)
            kind = rng.choice(["demand", "prefetch"])
            prio = rng.randint(0, 4)
            fn = f"f{nid}"
            nid += 1
            tf = link.Transfer(fn, nb, kind, prio)
            tr = link.Transfer(fn, nb, kind, prio)
            pairs[fn] = (tf, tr)
            fast.add(tf, now)
            scan.add(tr, now)
        elif op == "m":
            cands = [f for f, (t, _) in pairs.items() if t.kind != "demand"]
            if cands:
                fn = rng.choice(cands)
                fast.mark_demand(pairs[fn][0], now)
                scan.mark_demand(pairs[fn][1], now)
        elif op == "r":
            if pairs:
                fn = rng.choice(sorted(pairs))
                tf, tr = pairs.pop(fn)
                fast.remove(tf, now)
                scan.remove(tr, now)
        elif op == "k":
            cands = [f for f, (t, _) in pairs.items()
                     if t.chunk_rem is None and t.remaining > 1.0]
            if cands:
                fn = rng.choice(cands)
                tf, tr = pairs[fn]
                cr = rng.uniform(0.0, tf.remaining - 0.5)
                fast.arm_milestone(tf, cr, now)
                scan.arm_milestone(tr, cr, now)
        else:
            log.append(("milestones",
                        [t.fn_id for t in fast.pop_milestones(now)],
                        [t.fn_id for t in scan.pop_milestones(now)]))
            done = fast.pop_completed(now)
            log.append(("completed", [t.fn_id for t in done],
                        [t.fn_id for t in scan.pop_completed(now)]))
            for t in done:
                del pairs[t.fn_id]
        log.append((op, now, state()))
    for _ in range(10_000):
        e = fast.next_eta()
        if e is None:
            break
        drain.append((e, scan.next_eta(), now))
        now = max(e, now)
        log.append(("drain", [t.fn_id for t in fast.pop_milestones(now)],
                    [t.fn_id for t in scan.pop_milestones(now)],
                    [t.fn_id for t in fast.pop_completed(now)],
                    [t.fn_id for t in scan.pop_completed(now)]))
    return log, drain, sorted(pairs), len(fast.active), len(scan.active)


@pytest.mark.parametrize("seed", [0xFAB, 1, 2, 3, 41262])
def test_shared_link_programs_match_reference(seed):
    outer = random.Random(seed)
    for _ in range(40 if seed != 41262 else 1):
        s = outer.getrandbits(64) if seed != 41262 else seed
        want = _link_program(ref_link, random.Random(s))
        got = _link_program(port_link, random.Random(s))
        assert got == want, s
        log, drain = want[0], want[1]
        # the cached link plans as the scanning one in both packages
        assert all(e == e_scan for e, e_scan, _ in drain)
        for entry in log:
            if entry[0] in ("milestones", "completed"):
                assert entry[1] == entry[2]


def test_seed_41262_plans_the_same_past_eta_in_both_packages():
    """Reference behaviour the port mirrors: at seed 41262 the drain's
    ``next_eta()`` is 31.4776 after the time reached is 33.0382
    (tests/test_fabric.py's hypothesis fuzz fails on it); both packages
    plan exactly that past ETA."""
    want = _link_program(ref_link, random.Random(41262))
    got = _link_program(port_link, random.Random(41262))
    past = [(e, now) for e, _, now in want[1] if e < now - 1e-9]
    assert past == [(e, now) for e, _, now in got[1] if e < now - 1e-9]
    assert len(past) >= 1
    e, now = past[0]
    assert e == pytest.approx(31.4776, abs=1e-4)
    assert now == pytest.approx(33.0382, abs=1e-4)
    assert got == want
