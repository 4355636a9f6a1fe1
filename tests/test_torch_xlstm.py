"""The port's xLSTM and its mLSTM scan (K4) against ``repro``.

K4's plain version (the CPU path of the kernel wrapper, and the yardstick
the CUDA kernel is held against on the card) is held against the Pallas
kernel in interpret mode and ``mlstm_scan_ref`` from the empty state, and
against the model's own step, ``repro.models.xlstm._mlstm_step``, from a
nonzero state and from the model's zero state (m = 0, not the Pallas
kernel's -1e30). Reduced xlstm-350m (float32) on the reference's own
weights matches ``repro.models.xlstm_stack`` in logits and all seven state
leaves after prefill and after 4 decode steps. Tolerance 1e-4, the scans'
tolerance in ``tests/test_kernels.py``. Inputs come from numpy with a
seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.kernels.mlstm_scan.ops import mlstm_scan as pallas_mlstm  # noqa: E402
from repro.kernels.mlstm_scan.ref import mlstm_scan_ref  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402
from repro.models import xlstm_stack as ref_stack  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as k4  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

TOL = 1e-4
STEPS = 4
STATE_LEAVES = [("m", "C"), ("m", "n"), ("m", "m"),
                ("s", "c"), ("s", "n"), ("s", "m"), ("s", "h")]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _err(a, b) -> float:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _scan_inputs(seed, B, S, H, dh):
    """As ``tests/test_kernels.py::TestMlstmScan``: normal q, k, v, ig,
    and fg + 2 (forget gates mostly open), q and k scaled by dh^-0.5."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = r(B, S, H, dh) * dh ** -0.5, r(B, S, H, dh) * dh ** -0.5, \
        r(B, S, H, dh)
    return q, k, v, r(B, S, H), r(B, S, H) + 2.0


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _model_scan(q, k, v, ig, fg, state):
    """``jax.lax.scan`` of the model's ``_mlstm_step``, in model layout:
    returns h (B, S, H, dh) and the final (C, n, m)."""
    t = lambda a: jnp.asarray(a).swapaxes(0, 1)
    carry, hs = jax.lax.scan(ref_xlstm._mlstm_step,
                             tuple(jnp.asarray(s) for s in state),
                             (t(q), t(k), t(v), t(ig), t(fg)))
    return hs.swapaxes(0, 1), carry


@pytest.mark.parametrize("B,S,H,dh", [(2, 128, 2, 64), (1, 100, 4, 32)])
def test_plain_scan_matches_pallas_and_ref(B, S, H, dh):
    q, k, v, ig, fg = _scan_inputs(4, B, S, H, dh)
    h, _ = k4.mlstm_scan_plain(*_torch(q, k, v, ig, fg))
    pallas = pallas_mlstm(*(jnp.asarray(a) for a in (q, k, v, ig, fg)),
                          chunk=32)
    assert _err(h, pallas) < TOL
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, S, dh)
    gate = lambda a: a.transpose(0, 2, 1).reshape(B * H, S, 1)
    ref = mlstm_scan_ref(*(jnp.asarray(a) for a in (
        fold(q), fold(k), fold(v), gate(ig), gate(fg))))
    ref = np.asarray(ref).reshape(B, H, S, dh).transpose(0, 2, 1, 3)
    assert _err(h, ref) < TOL
    # the wrapper runs the plain version on a CPU tensor
    before = k4.mlstm_scan.launches
    hw, _ = k4.mlstm_scan(*_torch(q, k, v, ig, fg))
    assert torch.equal(hw, h) and k4.mlstm_scan.launches == before


@pytest.mark.parametrize("B,S,H,dh", [(2, 48, 2, 32), (1, 37, 4, 64)])
def test_plain_scan_from_nonzero_state_matches_model_step(B, S, H, dh):
    q, k, v, ig, fg = _scan_inputs(7, B, S, H, dh)
    rng = np.random.default_rng(8)
    state = (rng.standard_normal((B, H, dh, dh)).astype(np.float32) * 0.3,
             rng.standard_normal((B, H, dh)).astype(np.float32) * 0.3,
             rng.standard_normal((B, H)).astype(np.float32))
    h, (C, n, m) = k4.mlstm_scan_plain(*_torch(q, k, v, ig, fg),
                                       _torch(*state))
    rh, (rC, rn, rm) = _model_scan(q, k, v, ig, fg, state)
    for name, a, b in [("h", h, rh), ("C", C, rC), ("n", n, rn),
                       ("m", m, rm)]:
        assert _err(a, b) < TOL, name


def test_plain_scan_from_model_zero_state_follows_the_model():
    """The model's zero state has m = 0: the port follows the model's
    step there, and the Pallas kernel's m = -1e30 start differs. Gates
    as in ``test_kernels.py::test_matches_model_block_state`` (fg not
    shifted), so that log sigmoid(fg) often exceeds ig at step 0."""
    B, S, H, dh = 1, 48, 4, 32
    q, k, v, ig, fg = _scan_inputs(5, B, S, H, dh)
    fg = fg - 2.0
    zero = (np.zeros((B, H, dh, dh), np.float32),
            np.zeros((B, H, dh), np.float32), np.zeros((B, H), np.float32))
    h, (C, n, m) = k4.mlstm_scan_plain(*_torch(q, k, v, ig, fg),
                                       _torch(*zero))
    rh, (rC, rn, rm) = _model_scan(q, k, v, ig, fg, zero)
    for name, a, b in [("h", h, rh), ("C", C, rC), ("n", n, rn),
                       ("m", m, rm)]:
        assert _err(a, b) < TOL, name
    h_empty, _ = k4.mlstm_scan_plain(*_torch(q, k, v, ig, fg))
    assert _err(h_empty, rh) > 100 * TOL


def _setup(S, seed=3):
    rcfg = ref_config("xlstm-350m").reduced()
    pcfg = get_config("xlstm-350m").reduced()
    host = jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(seed)))
    tokens = np.random.default_rng(seed + 2).integers(
        0, rcfg.vocab_size, (2, S)).astype(np.int32)
    return rcfg, pcfg, host, tokens


def _close_state(rstate, pstate, what):
    for half, leaf in STATE_LEAVES:
        err = _err(pstate[half][leaf], rstate[half][leaf])
        assert err < TOL, (what, half, leaf, err)


@pytest.mark.parametrize("S", [48, 128])
def test_reduced_xlstm_matches_reference(S):
    """S = 128 takes the reference's chunked two-level scan."""
    rcfg, pcfg, host, tokens = _setup(S)
    model = build_model(pcfg)
    params = params_from_jax(host, device="cpu")
    rlogits, rstate = ref_stack.prefill(rcfg, host, jnp.asarray(tokens))
    plogits, pstate = model.prefill_fn(params, {"tokens":
                                                torch.from_numpy(tokens)})
    assert _err(plogits, rlogits) < TOL
    _close_state(rstate, pstate, "prefill")

    rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
    ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
    for i in range(STEPS):
        rlogits, rstate = ref_stack.decode_step(rcfg, host, rstate, rtok,
                                                S + i)
        plogits, pstate = model.decode_fn(params, pstate, ptok, S + i)
        assert _err(plogits, rlogits) < TOL, i
        _close_state(rstate, pstate, f"decode {i}")
        rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
        ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
        assert np.array_equal(np.asarray(rtok), ptok.numpy()), i


def test_decode_ignores_pos():
    rcfg, pcfg, host, tokens = _setup(8)
    model = build_model(pcfg)
    params = params_from_jax(host, device="cpu")
    _, state = model.prefill_fn(params, {"tokens": torch.from_numpy(tokens)})
    tok = torch.full((2, 1), 7, dtype=torch.int32)
    a, _ = model.decode_fn(params, state, tok, 8)
    b, _ = model.decode_fn(params, state, tok, 1000)
    assert torch.equal(a, b)


def test_param_table_and_init_match_reference_layout():
    from repro_torch.models.model import CachePlan, decode_cache_plan
    cfg = get_config("xlstm-350m").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    rcfg = ref_config("xlstm-350m").reduced()
    ref = jax.eval_shape(ref_build(rcfg).init_params, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    n_leaves = 0
    for path, leaf in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
        n_leaves += 1
    assert n_leaves == sum(1 for _ in _leaves(params)) == 18
    assert float(params["pairs"]["m_norm"].min()) == 1.0
    dm = 2 * cfg.d_model
    std = float(params["pairs"]["m_q"].std())
    assert abs(std - dm ** -0.5) < 0.1 * dm ** -0.5
    # the cache is the state: shapes and dtypes as the reference's
    assert decode_cache_plan(cfg, 64) == CachePlan("state", 0)
    ref_shapes = ref_stack.state_shapes(rcfg, 3)
    port_shapes = model.cache_shapes(3, CachePlan("state", 0))
    for half, leaf in STATE_LEAVES:
        rs, rd = ref_shapes[half][leaf]
        ps, pd = port_shapes[half][leaf]
        assert ps == rs and pd is torch.float32 and rd == jnp.float32
    zero = model.zero_cache(3, CachePlan("state", 0), "cpu")
    assert all(float(zero[h][k].abs().max()) == 0.0 for h, k in STATE_LEAVES)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_bridge_carries_xlstm_weights():
    """``params_from_jax`` moves the nested ``pairs`` subtree unchanged,
    in f32 and in bf16 (the full config's weight type)."""
    rcfg = dataclasses.replace(ref_config("xlstm-350m").reduced(),
                               param_dtype="bfloat16", dtype="bfloat16")
    host = jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(1)))
    params = params_from_jax(host, device="cpu")
    assert sorted(params) == sorted(host)
    assert sorted(params["pairs"]) == sorted(host["pairs"])
    for name, a in host["pairs"].items():
        t = params["pairs"][name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


L = k4.CHUNK


@pytest.mark.parametrize("gates", ["normal", "forget_closed", "input_open"])
@pytest.mark.parametrize("state", ["omitted", "zero", "random"])
@pytest.mark.parametrize("S", [1, L - 1, L, L + 1, 3 * L + 5])
def test_chunked_plain_matches_step_plain_and_model(S, state, gates):
    """The chunkwise form the CUDA kernel runs from one chunk up
    (``mlstm_scan_chunked_plain``, chunks of ``CHUNK`` steps) against the
    step loop and the model's ``_mlstm_step`` under ``jax.lax.scan``, at
    lengths around the chunk edges, from the omitted (m = -1e30), the
    model's zero (m = 0) and a random state, and with gates at the edges:
    forget gates shut (fg - 30: every step forgets almost all) and input
    gates wide open (ig + 30: m follows ig)."""
    B, H, dh = 1, 2, 32
    q, k, v, ig, fg = _scan_inputs(11, B, S, H, dh)
    if gates == "forget_closed":
        fg = fg - 30.0
    elif gates == "input_open":
        ig = ig + 30.0
    rng = np.random.default_rng(12)
    st = {"omitted": None,
          "zero": (np.zeros((B, H, dh, dh), np.float32),
                   np.zeros((B, H, dh), np.float32),
                   np.zeros((B, H), np.float32)),
          "random": (rng.standard_normal((B, H, dh, dh)).astype(np.float32)
                     * 0.3,
                     rng.standard_normal((B, H, dh)).astype(np.float32)
                     * 0.3,
                     rng.standard_normal((B, H)).astype(np.float32))}[state]
    args = _torch(q, k, v, ig, fg)
    ts = _torch(*st) if st is not None else None
    out = k4.mlstm_scan_chunked_plain(*args, ts)
    step = k4.mlstm_scan_plain(*args, ts)
    empty = (np.zeros((B, H, dh, dh), np.float32),
             np.zeros((B, H, dh), np.float32),
             np.full((B, H), k4.NEG_INF, np.float32))
    rh, rstate = _model_scan(q, k, v, ig, fg, st if st is not None
                             else empty)
    for name, a, b, c in zip(("h", "C", "n", "m"), (out[0],) + out[1],
                             (step[0],) + step[1], (rh,) + tuple(rstate)):
        assert _err(a, b) < TOL, name
        assert _err(a, c) < TOL, name
    assert k4.uses_chunks(S) == (S >= L)
