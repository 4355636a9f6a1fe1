"""The port's dense transformer against ``repro.models`` on the reference's
own weights.

Reduced qwen3-1.7b (float32), ``kv_quant`` off and on: the JAX model's
parameters go through ``repro_torch.bridge``; the prefill logits and every
cache leaf, then 4 greedy decode steps starting at ``pos = cache_len``
(past the end of the prompt-sized cache, where the reference's
dynamic_update_slice clamps the write into the last slot), match at 1e-4
and give the same greedy tokens (int8 cache leaves: see ``_close_leaf``). On the CPU the port's attention runs the
plain versions of K1-K3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402

TOL = 1e-4
B, S, STEPS = 2, 24, 4


def _setup(kv_quant: bool):
    rcfg = dataclasses.replace(ref_config("qwen3-1.7b").reduced(),
                               kv_quant=kv_quant)
    pcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               kv_quant=kv_quant)
    host = jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(3)))
    tokens = np.random.default_rng(5).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    return rcfg, pcfg, host, tokens


def _close(a, b, what):
    a = np.asarray(a, np.float32)
    b = b.float().numpy()
    assert a.shape == b.shape, what
    err = float(np.max(np.abs(a - b)))
    assert err < TOL, (what, err)


def _close_leaf(a, b, what):
    """Cache leaves: float leaves at TOL. An int8 leaf (kv_quant) holds
    round(x / scale), and x differs between the two sides at the 1e-7
    level (another summation order), so a value lying on a rounding tie
    may land one step apart: allow that for at most 1 in 1000 entries."""
    if b.dtype != torch.int8:
        return _close(a, b, what)
    diff = np.abs(np.asarray(a, np.int32) - b.numpy().astype(np.int32))
    assert diff.max() <= 1, what
    assert np.count_nonzero(diff) <= diff.size // 1000, (
        what, np.count_nonzero(diff))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_decode_match_reference(kv_quant):
    rcfg, pcfg, host, tokens = _setup(kv_quant)
    params = params_from_jax(host, device="cpu")
    rlogits, rcache = ref_tf.prefill(rcfg, host, jnp.asarray(tokens))
    plogits, pcache = port_tf.prefill(pcfg, params,
                                      torch.from_numpy(tokens))
    _close(rlogits, plogits, "prefill logits")
    assert sorted(rcache) == sorted(pcache)
    for name in rcache:
        _close_leaf(rcache[name], pcache[name], f"prefill cache {name}")

    rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
    ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
    for i in range(STEPS):
        pos = S + i           # past the cache's end: the clamped write
        rlogits, rcache = ref_tf.decode_step(rcfg, host, rcache, rtok, pos)
        plogits, pcache = port_tf.decode_step(pcfg, params, pcache, ptok,
                                              pos)
        _close(rlogits, plogits, f"decode logits {i}")
        for name in rcache:
            _close_leaf(rcache[name], pcache[name], f"decode {i} cache {name}")
        rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
        ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
        assert np.array_equal(np.asarray(rtok), ptok.numpy()), i


def test_decode_past_cache_end_writes_last_slot():
    """Both sides: a decode step at pos = cache_len changes only the last
    slot of the prompt-sized cache (the reference's clamp)."""
    rcfg, pcfg, host, tokens = _setup(False)
    params = params_from_jax(host, device="cpu")
    _, rcache = ref_tf.prefill(rcfg, host, jnp.asarray(tokens))
    _, pcache = port_tf.prefill(pcfg, params, torch.from_numpy(tokens))
    before = {k: v.clone() for k, v in pcache.items()}
    tok = np.full((B, 1), 7, np.int32)
    _, rnew = ref_tf.decode_step(rcfg, host, rcache, jnp.asarray(tok), S)
    _, pnew = port_tf.decode_step(pcfg, params, pcache,
                                  torch.from_numpy(tok), S)
    for name in ("k", "v"):
        rchg = np.any(np.asarray(rnew[name]) != np.asarray(rcache[name]),
                      axis=(0, 1, 3, 4))
        pchg = torch.any(pnew[name] != before[name], dim=(0, 1, 3, 4))
        assert rchg.tolist() == pchg.tolist() == [False] * (S - 1) + [True]


def test_bridge_keeps_bf16_bits_and_layout():
    import ml_dtypes
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 7)).astype(ml_dtypes.bfloat16)
    out = params_from_jax({"layers": {"w": a}, "b": np.arange(4.0)},
                          device="cpu")
    t = out["layers"]["w"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (3, 5, 7)
    assert np.array_equal(t.view(torch.int16).numpy(),
                          a.view(np.int16))
    assert out["b"].dtype == torch.float64


def test_param_table_and_init_match_reference_layout():
    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    ref = jax.eval_shape(ref_build(ref_config("qwen3-1.7b").reduced())
                         .init_params, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
    d = cfg.d_model
    assert float(params["layers"]["ln1"].min()) == 1.0
    std = float(params["layers"]["wq"].std())
    assert abs(std - d ** -0.5) < 0.1 * d ** -0.5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dataclasses.replace(cfg, family="retnet"))


def test_rms_norm_and_rope_match_reference():
    from repro.models import common as rc
    from repro_torch.models import common as pc
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    _close(rc.rms_norm(jnp.asarray(x), jnp.asarray(w)),
           pc.rms_norm(torch.from_numpy(x), torch.from_numpy(w)), "rms")
    pos = np.arange(6)
    for partial in (False, True):
        _close(rc.rope(jnp.asarray(x), jnp.asarray(pos), 1e6, partial),
               pc.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       partial), f"rope partial={partial}")
