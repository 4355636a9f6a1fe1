"""The port's MoE layer (``repro_torch.models.moe``) and MoE models against
``repro`` on the reference's own weights.

``moe_apply`` against ``repro.models.moe.moe_apply`` on one layer of
reduced granite-moe-3b-a800m: y and the aux loss on the dropless path
(T * k <= 4096) and on the capacity-bounded one (T 2080, k 2: 4160 pairs,
C = 1300), where a router skewed towards expert 0 overflows it and pairs
are dropped. Reduced granite-moe-3b-a800m and qwen3-moe-30b-a3b (float32),
``kv_quant`` off and on: prefill logits, every cache leaf and 4 greedy
decode steps. Tolerance 1e-4 in float32; int8 cache leaves by
``_close_leaf``, as ``tests/test_torch_model.py`` holds them (a decode
step whose new int8 entries land on a rounding tie: see
``check_prefill_and_decode``).

``jax.lax.top_k`` and ``torch.topk`` may order tied probabilities
differently, and a tie decides which expert a pair goes to: every input
here is checked to hold no near-tie at the k-th place (``_min_topk_gap``).
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
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402

TOL = 1e-4
STEPS = 4
MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]


def _err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = b.float().numpy()
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)))


def _close_leaf(a, b, what):
    """As ``tests/test_torch_model.py``: float leaves at TOL; an int8
    leaf may land one step apart on a rounding tie, in at most 1 in 1000
    entries."""
    if b.dtype != torch.int8:
        assert _err(a, b) < TOL, what
        return
    diff = np.abs(np.asarray(a, np.int32) - b.numpy().astype(np.int32))
    assert diff.max() <= 1, what
    assert np.count_nonzero(diff) <= diff.size // 1000, what


def _setup(arch, kv_quant=False, seed=3):
    rcfg = dataclasses.replace(ref_config(arch).reduced(), kv_quant=kv_quant)
    pcfg = dataclasses.replace(get_config(arch).reduced(), kv_quant=kv_quant)
    host = jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(seed)))
    return rcfg, pcfg, host


def _layer0(host):
    return {k: host["layers"][k][0] for k in ("router", "we1", "we3", "we2")}


def _min_topk_gap(x, router, k) -> float:
    """The smallest gap, over tokens, between the k-th and the (k+1)-th
    largest router logit (float64): the two sides' float32 logits differ
    by ~1e-6, so a gap above 1e-5 decides the same experts on both."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router
    logits = -np.sort(-logits, axis=-1)
    return float(np.min(logits[:, k - 1] - logits[:, k]))


def _moe_both(rcfg, pcfg, p_np, x):
    ry, raux = ref_moe.moe_apply(rcfg, jax.tree.map(jnp.asarray, p_np),
                                 jnp.asarray(x))
    py, paux = port_moe.moe_apply(pcfg, params_from_jax(p_np, device="cpu"),
                                  torch.from_numpy(x))
    return ry, raux, py, paux


def test_moe_apply_dropless_matches_reference():
    rcfg, pcfg, host = _setup("granite-moe-3b-a800m")
    p = _layer0(host)
    x = np.random.default_rng(0).standard_normal(
        (2, 24, rcfg.d_model)).astype(np.float32)
    T = x.shape[0] * x.shape[1]
    assert T * rcfg.top_k <= port_moe.DROPLESS_PAIRS
    assert port_moe.capacity(pcfg, T) == T * rcfg.top_k
    assert _min_topk_gap(x, p["router"], rcfg.top_k) > 1e-5
    ry, raux, py, paux = _moe_both(rcfg, pcfg, p, x)
    assert _err(ry, py) < TOL
    assert abs(float(raux) - float(paux)) < TOL


def test_moe_apply_capacity_path_drops_like_the_reference():
    """T 2080 at k 2: 4160 pairs, over the dropless limit, so C = 1300.
    Inputs with a common offset and a router column 0 tilted along it
    send nearly every token to expert 0, which overflows: the same pairs
    must be dropped on both sides."""
    rcfg, pcfg, host = _setup("granite-moe-3b-a800m")
    p = _layer0(host)
    p["router"] = np.array(p["router"])
    p["router"][:, 0] += 0.05
    x = (np.random.default_rng(1).standard_normal((2, 1040, rcfg.d_model))
         + 1.0).astype(np.float32)
    T, k, E = 2080, rcfg.top_k, rcfg.n_experts
    C = port_moe.capacity(pcfg, T)
    assert T * k > port_moe.DROPLESS_PAIRS and C == 1300
    assert _min_topk_gap(x, p["router"], k) > 1e-5
    logits = x.reshape(T, -1).astype(np.float64) @ p["router"]
    top = np.argsort(-logits, axis=-1)[:, :k]
    counts = np.bincount(top.reshape(-1), minlength=E)
    assert counts.max() > C, counts          # pairs are dropped
    ry, raux, py, paux = _moe_both(rcfg, pcfg, p, x)
    assert _err(ry, py) < TOL
    assert abs(float(raux) - float(paux)) < TOL
    # a dropped pair adds nothing: the port's y differs from the
    # dropless sum of the same experts
    big = dataclasses.replace(pcfg, capacity_factor=float(E))
    assert port_moe.capacity(big, T) >= counts.max()
    py_all, _ = port_moe.moe_apply(big, params_from_jax(p, device="cpu"),
                                   torch.from_numpy(x))
    assert float((py_all - py).abs().max()) > 1e-3


def test_moe_combine_adds_in_ascending_expert_order():
    """bf16, granite's k 8: each token's k contributions are added in
    ascending-expert order, rounded after each add, bit for bit as the
    reference's scatter-add ``zeros.at[st].add(y_sorted)``; the same sum
    in slot (top-k) order rounds differently somewhere."""
    import ml_dtypes
    T, k, E, d = 64, 8, 40, 256
    rng = np.random.default_rng(4)
    top_i = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    flat_e = top_i.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    st = order // k
    y_sorted = rng.standard_normal((T * k, d)).astype(ml_dtypes.bfloat16)
    ref = jnp.zeros((T, d), jnp.bfloat16).at[jnp.asarray(st)].add(
        jnp.asarray(y_sorted))
    ref_bits = np.asarray(ref).view(np.uint16)
    yt = torch.from_numpy(y_sorted.view(np.uint16)).view(torch.bfloat16)
    out = port_moe.combine_sorted(yt, torch.from_numpy(order), k)
    assert np.array_equal(out.view(torch.int16).numpy().view(np.uint16),
                          ref_bits)
    by_slot = torch.zeros((T, d), dtype=torch.bfloat16)
    y_pairs = torch.empty_like(yt)
    y_pairs[torch.from_numpy(order)] = yt
    for j in range(k):
        by_slot = by_slot + y_pairs.reshape(T, k, d)[:, j]
    assert not np.array_equal(
        by_slot.view(torch.int16).numpy().view(np.uint16), ref_bits)


def test_moe_param_table_matches_reference_layout():
    rcfg, pcfg, host = _setup("qwen3-moe-30b-a3b")
    params = build_model(pcfg).init_params(torch.Generator().manual_seed(0),
                                           "cpu")
    flat = jax.tree_util.tree_flatten_with_path(host)[0]
    for path, leaf in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert "w1" not in params["layers"]
    assert params["layers"]["router"].dtype == torch.float32


def _torch_cache(rcache):
    return {n: torch.from_numpy(np.array(rcache[n])) for n in rcache}


def _with_entries(rcache, idx):
    """A stand-in for the port's ``quantize_kv`` in a decode step: its
    calls (k then v, layer by layer) return the reference's new int8
    entries and scales at slot ``idx``."""
    calls = iter([(name, layer) for layer in range(rcache["k"].shape[0])
                  for name in ("k", "v")])

    def quantize_kv(x):
        name, layer = next(calls)
        q = np.array(rcache[name][layer][:, idx:idx + 1])
        sc = np.array(rcache[f"{name}_scale"][layer][:, idx:idx + 1])
        assert q.shape == tuple(x.shape)
        return torch.from_numpy(q), torch.from_numpy(sc)
    return quantize_kv


def check_prefill_and_decode(rcfg, pcfg, host, tokens, patch_embeds=None,
                             cache_len=None, ring=False, steps=STEPS):
    """Prefill on both sides, then ``steps`` greedy decode steps from the
    position after the prompt (patches and tokens): logits at TOL, every
    cache leaf by ``_close_leaf``, greedy tokens equal.

    Under ``kv_quant`` an int8 entry may sit one step apart on a rounding
    tie (``_close_leaf``), and a decode step attends over its own new
    entry, so such a tie moves that step's logits by one int8 step's
    share of the attention (3.5e-4 to 5.4e-3 seen on the reduced
    configs). So each step starts from the reference's cache, and a step
    whose new int8 entries differ is run again on the port with the
    reference's entries in place of its own quantizer's: the port's step
    is then held at TOL on the same cache, and its quantizer by
    ``_close_leaf``."""
    params = params_from_jax(host, device="cpu")
    rpe = ppe = None
    if patch_embeds is not None:
        rpe = jnp.asarray(patch_embeds)
        ppe = torch.from_numpy(patch_embeds)
    rlogits, rcache = ref_tf.prefill(rcfg, host, jnp.asarray(tokens),
                                     patch_embeds=rpe, cache_len=cache_len,
                                     ring=ring)
    plogits, pcache = port_tf.prefill(pcfg, params, torch.from_numpy(tokens),
                                      patch_embeds=ppe, cache_len=cache_len,
                                      ring=ring)
    assert _err(rlogits, plogits) < TOL
    assert sorted(rcache) == sorted(pcache)

    def leaves(what):
        """Check every leaf; True if the int8 leaves are equal."""
        same = True
        for name in rcache:
            _close_leaf(rcache[name], pcache[name], f"{what} {name}")
            if pcache[name].dtype == torch.int8:
                same &= np.array_equal(np.asarray(rcache[name]),
                                       pcache[name].numpy())
        return same
    leaves("prefill")
    rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
    ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
    pos0 = tokens.shape[1] + (0 if patch_embeds is None
                              else patch_embeds.shape[1])
    for i in range(steps):
        pos = pos0 + i
        start = rcache
        if pcfg.kv_quant:
            pcache = _torch_cache(start)
        rlogits, rcache = ref_tf.decode_step(rcfg, host, rcache, rtok, pos,
                                             ring=ring)
        plogits, pcache = port_tf.decode_step(pcfg, params, pcache, ptok,
                                              pos, ring=ring)
        if not leaves(f"decode {i}"):
            W = rcache["k"].shape[2]
            idx = pos % W if ring else min(pos, W - 1)
            saved = port_tf.attn.quantize_kv
            port_tf.attn.quantize_kv = _with_entries(rcache, idx)
            try:
                plogits, pcache = port_tf.decode_step(
                    pcfg, params, _torch_cache(start), ptok, pos, ring=ring)
            finally:
                port_tf.attn.quantize_kv = saved
            assert leaves(f"decode {i}, the reference's entries"), i
        assert _err(rlogits, plogits) < TOL, i
        rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
        ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
        assert np.array_equal(np.asarray(rtok), ptok.numpy()), i


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_prefill_and_decode_match_reference(arch, kv_quant):
    """B 2, S 24: a full cache sized to the prompt, decoded past its end
    (the reference's clamped write, as ``tests/test_torch_model.py``)."""
    rcfg, pcfg, host = _setup(arch, kv_quant)
    tokens = np.random.default_rng(5).integers(
        0, rcfg.vocab_size, (2, 24)).astype(np.int32)
    check_prefill_and_decode(rcfg, pcfg, host, tokens)
