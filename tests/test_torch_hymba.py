"""The port's Hymba (hybrid attention + SSM blocks) and its SSM scan (K5)
against ``repro``.

K5's plain version (the CPU path of the kernel wrapper, and the yardstick
the CUDA kernel is held against on the card) is held against the Pallas
kernel in interpret mode and ``ssm_scan_ref`` plus the D skip from the
zero state, and against a ``jax.lax.scan`` of the model's own step,
``repro.models.ssm._ssm_step``, from a nonzero state, in y and the final
state. ``causal_conv``, ``ssm_apply_seq`` and ``ssm_apply_decode`` are held
against the reference's on one layer; reduced hymba-1.5b (float32) on the
reference's own weights matches ``repro.models.transformer`` in logits and
every cache leaf after prefill and after 4 decode steps, and its ring
decode matches the reference's teacher-forced ``forward``.

The reference initialises a_log to 0 and d_skip to 1, so every head would
have A = -1 and D = 1 and a head-indexing fault would not show: every test
here draws a_log, d_skip and dt_bias from a seed. Tolerance 1e-4, the
scans' tolerance in ``tests/test_kernels.py``. Inputs come from numpy with
a seed.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.kernels.ssm_scan.ops import ssm_scan as pallas_ssm  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import decode_cache_plan as ref_plan  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as k5  # noqa: E402
from repro_torch.models import build_model, decode_cache_plan  # noqa: E402
from repro_torch.models import ssm as port_ssm  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402

TOL = 1e-4
STEPS = 4
HYBRID_LEAVES = ["in_proj", "conv_w", "dt_proj", "dt_bias", "b_proj",
                 "c_proj", "a_log", "d_skip", "out_proj", "attn_out_norm",
                 "ssm_out_norm"]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _err(a, b) -> float:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _scan_inputs(seed, B, S, Hs, P, N):
    """As ``tests/test_kernels.py::TestSsmScan``: normal x, b, c, d_skip,
    dt = softplus(normal), a_log = 0.3 * normal."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, dt = r(B, S, Hs, P), np.logaddexp(r(B, S, Hs), 0).astype(np.float32)
    a_log, b, c, d_skip = r(Hs) * 0.3, r(B, S, N), r(B, S, N), r(Hs)
    return x, dt, a_log, b, c, d_skip


@pytest.mark.parametrize("B,S,Hs,P,N", [
    (2, 96, 2, 32, 16), (1, 64, 4, 64, 8), (1, 50, 1, 16, 16)])
def test_plain_scan_matches_pallas_and_ref(B, S, Hs, P, N):
    x, dt, a_log, b, c, d_skip = _scan_inputs(6, B, S, Hs, P, N)
    y, _ = k5.ssm_scan_plain(*_torch(x, dt, a_log, b, c, d_skip))
    pallas = pallas_ssm(*(jnp.asarray(a) for a in (x, dt, a_log, b, c,
                                                   d_skip)))
    assert _err(y, pallas) < TOL
    decay = np.exp(dt * -np.exp(a_log))
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(B * Hs, S, -1)
    gate = lambda a: a.transpose(0, 2, 1).reshape(B * Hs, S, 1)
    heads = lambda a: np.broadcast_to(a[:, None], (B, Hs, S, N)).reshape(
        B * Hs, S, N)
    ref = ssm_scan_ref(*(jnp.asarray(a) for a in (
        fold(x), gate(decay), gate(dt), heads(b), heads(c))))
    ref = np.asarray(ref).reshape(B, Hs, S, P).transpose(0, 2, 1, 3)
    ref = ref + d_skip[None, None, :, None] * x
    assert _err(y, ref) < TOL
    # the wrapper runs the plain version on a CPU tensor, launching nothing
    before = k5.ssm_scan.launches
    yw, _ = k5.ssm_scan(*_torch(x, dt, a_log, b, c, d_skip))
    assert torch.equal(yw, y) and k5.ssm_scan.launches == before


def _model_scan(x, dt, a_log, b, c, d_skip, state):
    """``jax.lax.scan`` of the model's ``_ssm_step`` plus the D skip, in
    model layout: returns y (B, S, Hs, P) and the final state."""
    t = lambda a: jnp.asarray(a).swapaxes(0, 1)
    A = -jnp.exp(jnp.asarray(a_log))
    state, ys = jax.lax.scan(partial(ref_ssm._ssm_step, A=A),
                             jnp.asarray(state), (t(x), t(dt), t(b), t(c)))
    y = ys.swapaxes(0, 1) + jnp.asarray(d_skip)[None, None, :, None] * x
    return y, state


@pytest.mark.parametrize("S", [1, 50, 128])
@pytest.mark.parametrize("B,Hs,P,N", [(2, 3, 32, 16), (1, 4, 16, 8)])
def test_plain_scan_from_nonzero_state_matches_model_step(B, S, Hs, P, N):
    x, dt, a_log, b, c, d_skip = _scan_inputs(7, B, S, Hs, P, N)
    state = np.random.default_rng(8).standard_normal(
        (B, Hs, P, N)).astype(np.float32)
    y, fin = k5.ssm_scan_plain(*_torch(x, dt, a_log, b, c, d_skip),
                               *_torch(state))
    ry, rfin = _model_scan(x, dt, a_log, b, c, d_skip, state)
    assert _err(y, ry) < TOL
    assert _err(fin, rfin) < TOL
    # a bfloat16 x gives y in bfloat16, the state in float32
    yb, finb = k5.ssm_scan_plain(torch.from_numpy(x).bfloat16(),
                                 *_torch(dt, a_log, b, c, d_skip, state))
    assert yb.dtype == torch.bfloat16 and finb.dtype == torch.float32


@pytest.mark.parametrize("S", [1, 50])
def test_causal_conv_from_nonzero_state(S):
    rng = np.random.default_rng(9)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    xin, conv_state, w = r(2, S, 24), r(2, 3, 24), r(4, 24) * 0.5
    out, new = port_ssm.causal_conv(*_torch(xin, conv_state, w))
    rout, rnew = ref_ssm.causal_conv(jnp.asarray(xin),
                                     jnp.asarray(conv_state), jnp.asarray(w))
    assert _err(out, rout) < TOL
    assert _err(new, rnew) < TOL


def _perturb(host, seed):
    """a_log, d_skip and dt_bias drawn from a seed, every layer and head
    apart (the reference's init makes them 0, 1 and 0)."""
    rng = np.random.default_rng(seed)
    layers = dict(host["layers"])
    for name, scale, shift in [("a_log", 0.3, 0.0), ("d_skip", 1.0, 0.0),
                               ("dt_bias", 0.5, -0.5)]:
        a = layers[name]
        layers[name] = (rng.standard_normal(a.shape) * scale
                        + shift).astype(a.dtype)
    return {**host, "layers": layers}


def _ref_host(seed, **overrides):
    rcfg = dataclasses.replace(ref_config("hymba-1.5b").reduced(),
                               **overrides)
    pcfg = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                               **overrides)
    host = jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(seed)))
    return rcfg, pcfg, _perturb(host, seed + 1)


@pytest.mark.parametrize("S", [1, 50])
def test_ssm_apply_matches_reference_on_one_layer(S):
    rcfg, pcfg, host = _ref_host(3)
    p = {k: v[0] for k, v in host["layers"].items()}
    pp = params_from_jax(p, device="cpu")
    rng = np.random.default_rng(4)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    Hs, P, N = rcfg.ssm_heads, rcfg.ssm_head_dim, rcfg.ssm_state
    x = r(2, S, rcfg.d_model)
    state, conv = r(2, Hs, P, N), r(2, rcfg.conv_width - 1, Hs * P)
    apply_ref, apply_port = ((ref_ssm.ssm_apply_decode,
                              port_ssm.ssm_apply_decode) if S == 1 else
                             (ref_ssm.ssm_apply_seq, port_ssm.ssm_apply_seq))
    ry, rstate, rconv = apply_ref(rcfg, p, jnp.asarray(x), jnp.asarray(state),
                                  jnp.asarray(conv))
    py, pstate, pconv = apply_port(pcfg, pp, *_torch(x, state, conv),
                                   k5.ssm_scan)
    for name, a, b in [("y", py, ry), ("ssm_state", pstate, rstate),
                       ("conv_state", pconv, rconv)]:
        assert _err(a, b) < TOL, name


def _close_leaf(a, b, what):
    """Cache leaves at TOL; an int8 leaf (kv_quant) holds round(x / scale),
    and x differs between the two sides at the 1e-7 level, so a value on a
    rounding tie may land one step apart: allowed for at most 1 in 1000
    entries (as in ``tests/test_torch_model.py``)."""
    if b.dtype != torch.int8:
        assert _err(b, a) < TOL, what
        return
    diff = np.abs(np.asarray(a, np.int32) - b.numpy().astype(np.int32))
    assert diff.max() <= 1, what
    assert np.count_nonzero(diff) <= diff.size // 1000, what


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("S", [48, 96])
def test_reduced_hymba_matches_reference(S, kv_quant):
    """S = 96 against the reduced window of 64: the prefill's window mask
    and the ring's wrap both act; at S = 48 the ring is 48 slots and the
    first decode step wraps it."""
    rcfg, pcfg, host = _ref_host(5, kv_quant=kv_quant)
    plan, rplan = decode_cache_plan(pcfg, S), ref_plan(rcfg, S)
    assert plan.ring and (plan.kind, plan.length) == (rplan.kind,
                                                      rplan.length)
    params = params_from_jax(host, device="cpu")
    tokens = np.random.default_rng(6).integers(
        0, rcfg.vocab_size, (2, S)).astype(np.int32)
    rlogits, rcache = ref_tf.prefill(rcfg, host, jnp.asarray(tokens),
                                     cache_len=plan.length, ring=True)
    plogits, pcache = port_tf.prefill(pcfg, params, torch.from_numpy(tokens),
                                      cache_len=plan.length, ring=True)
    assert _err(plogits, rlogits) < TOL
    assert sorted(pcache) == sorted(rcache)
    assert {"ssm_state", "conv_state"} <= set(pcache)
    for name in rcache:
        _close_leaf(rcache[name], pcache[name], f"prefill {name}")

    rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
    ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
    for i in range(STEPS):
        rlogits, rcache = ref_tf.decode_step(rcfg, host, rcache, rtok, S + i,
                                             ring=True)
        plogits, pcache = port_tf.decode_step(pcfg, params, pcache, ptok,
                                              S + i, ring=True)
        assert _err(plogits, rlogits) < TOL, i
        for name in rcache:
            _close_leaf(rcache[name], pcache[name], f"decode {i} {name}")
        rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
        ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
        assert np.array_equal(np.asarray(rtok), ptok.numpy()), i


def test_ring_decode_matches_reference_windowed_forward():
    """As ``tests/test_decode_consistency.py::
    test_ring_decode_matches_windowed_forward`` for hymba: window 16, 40
    tokens, a 24-token prompt; the port's prefill and teacher-forced ring
    decode against the reference's full-sequence ``forward``."""
    rcfg, pcfg, host = _ref_host(0, sliding_window=16)
    B, S, prompt = 1, 40, 24
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    full, _ = ref_tf.forward(rcfg, host, jnp.asarray(tokens))
    plan = decode_cache_plan(pcfg, S)
    assert plan.ring and plan.length == 16
    model = build_model(pcfg)
    params = params_from_jax(host, device="cpu")
    t = torch.from_numpy(tokens)
    logits, cache = model.prefill_fn(params, {"tokens": t[:, :prompt]},
                                     plan.length, plan.ring)
    assert _err(logits, full[:, prompt - 1]) < TOL
    for pos in range(prompt, S):
        logits, cache = model.decode_fn(params, cache, t[:, pos:pos + 1],
                                        pos, plan.ring)
        assert _err(logits, full[:, pos]) < TOL, pos


def test_param_table_and_cache_match_reference_layout():
    from repro_torch.models.model import CachePlan
    cfg = get_config("hymba-1.5b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    rcfg = ref_config("hymba-1.5b").reduced()
    ref = jax.eval_shape(ref_build(rcfg).init_params, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert set(HYBRID_LEAVES) <= set(params["layers"])
    assert float(params["layers"]["d_skip"].min()) == 1.0
    assert float(params["layers"]["a_log"].abs().max()) == 0.0
    plan = CachePlan("ring", 64)
    ref_shapes = ref_build(rcfg).cache_shapes(3, plan)
    port_shapes = model.cache_shapes(3, plan)
    assert sorted(port_shapes) == sorted(ref_shapes)
    for name, (rs, rd) in ref_shapes.items():
        ps, pd = port_shapes[name]
        assert ps == rs and str(pd).split(".")[-1] == jnp.dtype(rd).name
    zero = model.zero_cache(3, plan, "cpu")
    assert all(float(v.abs().max()) == 0.0 for v in zero.values())


def test_bridge_carries_hybrid_weights():
    """``params_from_jax`` moves the hybrid leaves unchanged, in bf16 (the
    full config's weight type)."""
    rcfg = dataclasses.replace(ref_config("hymba-1.5b").reduced(),
                               param_dtype="bfloat16", dtype="bfloat16")
    host = jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(1)))
    host = _perturb(host, 2)
    params = params_from_jax(host, device="cpu")
    assert sorted(params["layers"]) == sorted(host["layers"])
    for name in HYBRID_LEAVES:
        a, t = host["layers"][name], params["layers"][name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


L = k5.CHUNK


@pytest.mark.parametrize("dt_scale", [1.0, 200.0])
@pytest.mark.parametrize("state", ["omitted", "zero", "random"])
@pytest.mark.parametrize("S", [1, L - 1, L, L + 1, 3 * L + 5])
def test_chunked_plain_matches_step_plain_and_model(S, state, dt_scale):
    """The chunked (state-space duality) form the CUDA kernel runs from
    one chunk up (``ssm_scan_chunked_plain``, chunks of ``CHUNK`` steps)
    against the step loop and the model's ``_ssm_step`` under
    ``jax.lax.scan`` plus the D skip, at lengths around the chunk edges,
    from the omitted, a zero and a random state, and with dt scaled by 200
    so that exp(dt A) and the chunk's cumulated decays underflow to 0 (x
    scaled by 1 / 200 beside it, so that dt x and y stay of order 1 and
    the absolute tolerance means what it means at dt scale 1)."""
    B, Hs, P, N = 2, 3, 16, 8
    x, dt, a_log, b, c, d_skip = _scan_inputs(13, B, S, Hs, P, N)
    dt = (dt * dt_scale).astype(np.float32)
    x = (x / dt_scale).astype(np.float32)
    assert dt_scale == 1.0 or np.exp(dt * -np.exp(a_log)).min() == 0.0
    st = {"omitted": None,
          "zero": np.zeros((B, Hs, P, N), np.float32),
          "random": np.random.default_rng(14).standard_normal(
              (B, Hs, P, N)).astype(np.float32)}[state]
    args = _torch(x, dt, a_log, b, c, d_skip)
    ts = torch.from_numpy(st) if st is not None else None
    y, fin = k5.ssm_scan_chunked_plain(*args, ts)
    sy, sfin = k5.ssm_scan_plain(*args, ts)
    ry, rfin = _model_scan(x, dt, a_log, b, c, d_skip,
                           st if st is not None
                           else np.zeros((B, Hs, P, N), np.float32))
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    for a, s_, r in [(y, sy, ry), (fin, sfin, rfin)]:
        assert _err(a, s_) < TOL
        assert _err(a, r) < TOL
    assert k5.uses_chunks(S) == (S >= L)


SPAN = k5.CLUSTER * L   # steps a cluster's spans hold at one chunk each


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("S,ctas", [
    (2 * SPAN, k5.CLUSTER),          # every span two whole chunks
    (2 * SPAN + 13, k5.CLUSTER),     # ragged: spans of 2 and 3 chunks
    (3 * L + 5, k5.CLUSTER),         # below one span a CTA: 4 spans
    (L + 1, k5.CLUSTER),             # two spans, the second of 1 step
    (5 * L + 7, 3)])                 # spans of 2, 2 and 2 chunks
def test_spans_plain_matches_plain_and_reference(S, ctas, state):
    """The Hopper kernel's arithmetic (``ssm_scan_spans_plain``: the chunks
    split into spans, each span's summary an increment and a product of
    per-chunk decays, each span's start state composed from the earlier
    summaries) against the step loop and the JAX package: from the zero
    state against ``ssm_scan_bhspn`` in interpret mode and
    ``ssm_scan_ref``, both plus the D skip; from a random state against
    the model's ``_ssm_step`` under ``jax.lax.scan``."""
    B, Hs, P, N = 1, 2, 16, 8
    x, dt, a_log, b, c, d_skip = _scan_inputs(15, B, S, Hs, P, N)
    st = np.random.default_rng(16).standard_normal(
        (B, Hs, P, N)).astype(np.float32) if state else None
    args = _torch(x, dt, a_log, b, c, d_skip)
    ts = torch.from_numpy(st) if state else None
    y, fin = k5.ssm_scan_spans_plain(*args, ts, ctas=ctas)
    sy, sfin = k5.ssm_scan_plain(*args, ts)
    assert _err(y, sy) < TOL and _err(fin, sfin) < TOL
    if state:
        ry, rfin = _model_scan(x, dt, a_log, b, c, d_skip, st)
        assert _err(y, ry) < TOL and _err(fin, rfin) < TOL
        return
    pallas = pallas_ssm(*(jnp.asarray(a) for a in (x, dt, a_log, b, c,
                                                   d_skip)))
    assert _err(y, pallas) < TOL
    decay = np.exp(dt * -np.exp(a_log))
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(B * Hs, S, -1)
    gate = lambda a: a.transpose(0, 2, 1).reshape(B * Hs, S, 1)
    heads = lambda a: np.broadcast_to(a[:, None], (B, Hs, S, N)).reshape(
        B * Hs, S, N)
    ref = ssm_scan_ref(*(jnp.asarray(a) for a in (
        fold(x), gate(decay), gate(dt), heads(b), heads(c))))
    ref = np.asarray(ref).reshape(B, Hs, S, P).transpose(0, 2, 1, 3)
    assert _err(y, ref + d_skip[None, None, :, None] * x) < TOL
