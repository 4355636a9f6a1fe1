"""The port's batch simulator (``repro_torch.batchsim``) on the CPU.

It is held per lane to the reference's ``repro.batchsim.run_batch`` and
to the port's scalar ``SimExecutor`` (``run_scalar_reference``), on
``tests/test_batchsim.py``'s trace and ``CASES``, plus plain-MQFQ
(sticky=False) lanes: both batch planes draw those from ``_splitmix``,
so they match the reference's batch plane too. Required per lane:
dispatch order and start types exactly, dispatch and completion times
to 1e-9, integer aggregates exactly.

``import repro.batchsim`` turns on ``jax_enable_x64`` for the whole
process, which would change the JAX side of other parity tests that
share a worker; so it is imported inside a module-scoped fixture that
restores the previous value (and ``XLA_FLAGS``) at teardown, and the
reference's ``run_batch`` runs only under it.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.batchsim import (FAM_FCFS, FAM_MQFQ, FAM_SJF,  # noqa: E402
                                  build_consts, init_state, make_params,
                                  simulate_one)
from repro_torch.batchsim import step as port_step  # noqa: E402
from repro_torch.batchsim.sweep import (fig8_grid, run_batch,  # noqa: E402
                                        run_scalar_reference,
                                        sensitivity_grid)
from repro_torch.workloads.traces import padded_arrivals  # noqa: E402

GB = 2 ** 30
TRACE_KW = dict(n_fns=8, duration=300.0, total_rps=1.0, seed=3)

# tests/test_batchsim.py's differential matrix
CASES = [
    ("sticky-mempress", dict(family=FAM_MQFQ, T=5.0, alpha=2.0,
                             sticky=True, pool_size=3,
                             capacity_bytes=2.5 * GB, h2d_bw=8 * GB, d=2)),
    ("sfq-d1", dict(family=FAM_MQFQ, T=0.0, alpha=2.0, sticky=True, d=1)),
    ("vt-unit", dict(family=FAM_MQFQ, T=10.0, alpha=1.0, sticky=True,
                     vt_by_service=False, d=2)),
    ("deficit-d3", dict(family=FAM_MQFQ, T=10.0, alpha=2.0, sticky=True,
                        deficit_vt=True, d=3)),
    ("fcfs", dict(family=FAM_FCFS, d=2)),
    ("sjf", dict(family=FAM_SJF, d=2)),
    ("window10", dict(family=FAM_MQFQ, T=10.0, alpha=4.0, sticky=True,
                      fairness_window=10.0, d=2)),
]
# plain MQFQ (sticky=False): a splitmix64 draw in both batch planes,
# never the scalar plane's Mersenne stream
PLAIN = [
    ("plain-mempress", dict(family=FAM_MQFQ, T=5.0, alpha=2.0,
                            sticky=False, pool_size=3,
                            capacity_bytes=2.5 * GB, h2d_bw=8 * GB, d=2,
                            seed=7)),
    ("plain-d3", dict(family=FAM_MQFQ, T=10.0, alpha=2.0, sticky=False,
                      d=3, seed=2**63 + 12345)),
]
LANES = CASES + PLAIN

INT_KEYS = ("cold", "warm", "host_warm", "pool_evictions", "decisions",
            "n_windows", "invocations")
FLOAT_KEYS = ("mean_latency", "p50_latency", "p99_latency", "gap_max",
              "gap_mean", "bound_mean", "mean_utilization", "duration")
FLOAT_TOL = 1e-9


@pytest.fixture(scope="module")
def ref_batchsim():
    """The reference's batch simulator, imported with x64 on; the
    previous x64 setting and XLA_FLAGS come back at teardown."""
    import jax
    prev_x64 = jax.config.jax_enable_x64
    prev_flags = os.environ.get("XLA_FLAGS")
    try:
        import repro.batchsim  # noqa: F401  (sets x64)
        from repro.batchsim import step, sweep
        jax.config.update("jax_enable_x64", True)
        yield sweep, step
    finally:
        jax.config.update("jax_enable_x64", prev_x64)
        if prev_flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev_flags


@pytest.fixture(scope="module")
def trace():
    return padded_arrivals("zipf", **TRACE_KW)


@pytest.fixture(scope="module")
def points(trace):
    F = len(trace.fn_ids)
    return [make_params(F, **kw) for _, kw in LANES]


@pytest.fixture(scope="module")
def port_batch(trace, points):
    return run_batch(trace, points, device="cpu")


@pytest.fixture(scope="module")
def ref_batch(ref_batchsim, points):
    from repro.workloads.traces import padded_arrivals as ref_padded
    sweep, _ = ref_batchsim
    return sweep.run_batch(ref_padded("zipf", **TRACE_KW), points)


def _check_lane(trace, out, g, order, dispatch, completion, start, agg):
    n = int(trace.n_events)
    raw = out["raw"]
    got = raw["o_order"][g, :n]
    assert (got == order).all(), (
        f"dispatch order diverged on {int((got != order).sum())} of {n}")
    np.testing.assert_allclose(raw["o_dispatch"][g, :n], dispatch,
                               rtol=0, atol=FLOAT_TOL)
    np.testing.assert_allclose(raw["o_completion"][g, :n], completion,
                               rtol=0, atol=FLOAT_TOL)
    assert (raw["o_start"][g, :n] == start).all()
    s = out["summary"][g]
    for k in INT_KEYS:
        assert int(s[k]) == int(agg[k]), (k, s[k], agg[k])
    for k in FLOAT_KEYS:
        assert abs(float(s[k]) - float(agg[k])) <= FLOAT_TOL, \
            (k, s[k], agg[k])


@pytest.mark.parametrize("g", range(len(LANES)),
                         ids=[name for name, _ in LANES])
def test_lane_matches_reference_batch(trace, port_batch, ref_batch, g):
    n = int(trace.n_events)
    rraw = ref_batch["raw"]
    _check_lane(trace, port_batch, g,
                np.asarray(rraw["o_order"][g, :n]),
                np.asarray(rraw["o_dispatch"][g, :n]),
                np.asarray(rraw["o_completion"][g, :n]),
                np.asarray(rraw["o_start"][g, :n]),
                ref_batch["summary"][g])
    for k in ("events", "decisions"):
        assert port_batch["summary"][g][k] == ref_batch["summary"][g][k]


@pytest.mark.parametrize("g", range(len(CASES)),
                         ids=[name for name, _ in CASES])
def test_lane_matches_scalar_plane(trace, points, port_batch, g):
    ref = run_scalar_reference(trace, points[g])
    n = int(trace.n_events)
    order = np.full(n, -1, dtype=np.int64)
    for rank, inv in enumerate(ref["order"]):
        order[inv] = rank
    _check_lane(trace, port_batch, g, order, ref["dispatch"],
                ref["completion"], ref["start"], ref)


def test_splitmix_and_draw_match_reference_bit_for_bit(ref_batchsim):
    import jax.numpy as jnp
    _, ref_step = ref_batchsim
    rng = np.random.default_rng(0)
    seeds = np.concatenate([
        rng.integers(0, 2**63, 200, dtype=np.uint64) * np.uint64(2)
        + rng.integers(0, 2, 200, dtype=np.uint64),
        np.array([0, 1, 2**63, 2**64 - 1], dtype=np.uint64)])
    ns = rng.integers(0, 2**31 - 1, seeds.size).astype(np.int32)
    ns[:4] = [0, 1, 2**31 - 1, 12345]
    want = np.asarray(ref_step._splitmix(jnp.asarray(seeds),
                                         jnp.asarray(ns)))
    got = port_step._splitmix(torch.from_numpy(seeds.view(np.int64)),
                              torch.from_numpy(ns))
    assert (got.numpy().view(np.uint64) == want).all()
    for cnt in (1, 2, 3, 7, 19, 96, 2**31 - 1):
        m = np.full(seeds.size, cnt, dtype=np.int64)
        r_want = np.asarray(jnp.asarray(want)
                            % jnp.maximum(jnp.asarray(m), 1)
                            .astype(jnp.uint64))
        r_got = port_step._umod(got, torch.from_numpy(m))
        assert (r_got.numpy() == r_want.astype(np.int64)).all(), cnt


def test_simulate_one_matches_run_batch(trace, points, port_batch):
    F, NE = len(trace.fn_ids), trace.times.shape[0]
    S = max(int(p["d"]) for p in points)
    C = max(int(p["pool_size"]) for p in points) + S + 1
    from repro_torch.batchsim.sweep import stack_params
    st = simulate_one(stack_params(points, "cpu"),
                      build_consts(trace, device="cpu"),
                      init_state(F, NE, S, C, 2 * F + 8, G=len(points),
                                 device="cpu"))
    assert not st["step_overflow"].any()
    assert np.array_equal(st["o_rec"].numpy(), port_batch["raw"]["o_rec"])
    for k in ("cold", "warm", "decisions", "events", "util_integral"):
        assert np.array_equal(st[k].numpy(), port_batch["raw"][k]), k


def test_run_batch_reuses_consts_and_init(trace, points, port_batch):
    F, NE = len(trace.fn_ids), trace.times.shape[0]
    consts = build_consts(trace, device="cpu")
    pts = points[:3]
    S = max(int(p["d"]) for p in pts)
    C = max(int(p["pool_size"]) for p in pts) + S + 1
    init = init_state(F, NE, S, C, 2 * F + 8, G=3, device="cpu")
    before = {k: v.clone() for k, v in init.items()}
    out = run_batch(trace, pts, consts=consts, init=init, device="cpu")
    again = run_batch(trace, pts, consts=consts, init=init, device="cpu")
    for k, v in init.items():
        assert torch.equal(v, before[k]), k      # init is not modified
    assert np.array_equal(out["raw"]["o_rec"], again["raw"]["o_rec"])
    assert np.array_equal(out["raw"]["o_rec"],
                          port_batch["raw"]["o_rec"][:3])
    assert out["syncs"] > 0 and out["device"] == "cpu"


def test_grids_are_the_reference_grids(ref_batchsim):
    sweep, _ = ref_batchsim
    for ours, theirs in ((fig8_grid, sweep.fig8_grid),
                         (sensitivity_grid, sweep.sensitivity_grid)):
        a, b = ours(19), theirs(19)
        assert [name for name, _ in a] == [name for name, _ in b]
        for (_, pa_), (_, pb) in zip(a, b):
            assert pa_.keys() == pb.keys()
            for k in pa_:
                assert np.array_equal(pa_[k], pb[k]), k
                assert pa_[k].dtype == pb[k].dtype, k
    assert len(sensitivity_grid(19)) == 144


def test_step_cap_raises_not_truncates(trace):
    F = len(trace.fn_ids)
    with pytest.raises(RuntimeError, match="step cap"):
        run_batch(trace, [make_params(F)], max_steps=7, device="cpu")


def test_padded_arrivals_match_reference():
    from repro.workloads.traces import padded_arrivals as ref_padded
    for kind, kw in (("zipf", TRACE_KW),
                     ("azure", dict(n_fns=19, duration=600.0, trace_id=4))):
        a, b = padded_arrivals(kind, **kw), ref_padded(kind, **kw)
        assert a.fn_ids == b.fn_ids and a.n_events == b.n_events
        for field in ("times", "fn_idx", "per_fn_times", "per_fn_counts"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field


def test_oversize_grid_raises_clear_error():
    kw = dict(n_fns=4, duration=60.0, total_rps=2.0, seed=0)
    pa = padded_arrivals("zipf", **kw)
    with pytest.raises(ValueError, match="refusing to truncate"):
        padded_arrivals("zipf", capacity=int(pa.n_events) - 1, **kw)
    with pytest.raises(ValueError, match="refusing to truncate"):
        padded_arrivals(
            "zipf", per_fn_capacity=int(pa.per_fn_counts.max()) - 1, **kw)
    big = padded_arrivals("zipf", capacity=int(pa.n_events) + 32, **kw)
    assert np.all(np.isinf(big.times[int(big.n_events):]))
    # a padded trace runs the same lanes as the unpadded one
    F = len(pa.fn_ids)
    pts = [make_params(F, **kw_) for _, kw_ in CASES[:2]]
    tight = run_batch(pa, pts, device="cpu")
    loose = run_batch(big, pts, device="cpu")
    n = int(pa.n_events)
    assert np.array_equal(tight["raw"]["o_rec"][:, :n],
                          loose["raw"]["o_rec"][:, :n])
    assert tight["summary"] == loose["summary"]
