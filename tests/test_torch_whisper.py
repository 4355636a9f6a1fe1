"""The port's Whisper (``repro_torch.models.whisper``) against
``repro.models.whisper`` on the reference's own weights and inputs.

Reduced whisper-large-v3 (float32: 2 encoder and 2 decoder layers, d 256,
4 heads, 32 frames, a 128-entry decoder position table), ``kv_quant`` off
and on: ``layer_norm`` and the tanh GELU, the encoder's sinusoid (also at
the full 1500 x 1280), the encoder's output, the prefill logits and every
cache leaf (``k``, ``v``, ``ck``, ``cv`` and their scales), 8 greedy
decode steps past the end of a prompt-sized cache (the reference's
clamped write), all at 1e-4 (int8 leaves by ``tests/test_torch_moe.py``'s
rounding-tie rule). The port's decode against the port's teacher-forced
``forward``, as ``tests/test_decode_consistency.py`` holds the
reference's; ``TorchEndpoint``'s greedy tokens against ``JaxEndpoint``'s;
the decoder position table's clamp at its end. On the CPU the kernel
wrappers run their plain versions.
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
from repro.models import common as ref_common  # noqa: E402
from repro.models import whisper as ref_wh  # noqa: E402
from repro.runtime.device import JaxEndpoint  # noqa: E402
from repro.shapes import InputShape as RefShape  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, decode_cache_plan  # noqa: E402
from repro_torch.models import common as port_common  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models import whisper as port_wh  # noqa: E402
from repro_torch.runtime.device import TorchEndpoint  # noqa: E402
from repro_torch.shapes import InputShape  # noqa: E402
from test_torch_moe import (_close_leaf, _err, _torch_cache,  # noqa: E402
                            _with_entries)

TOL = 1e-4
ARCH = "whisper-large-v3"
B, S, STEPS = 2, 16, 8


def _setup(kv_quant=False, seed=3):
    rcfg = dataclasses.replace(ref_config(ARCH).reduced(), kv_quant=kv_quant)
    pcfg = dataclasses.replace(get_config(ARCH).reduced(), kv_quant=kv_quant)
    host = jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(seed)))
    return rcfg, pcfg, host


def _inputs(cfg, S_text=S, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_text)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.encoder_len, cfg.d_model))
              * 0.02).astype(np.float32)
    return tokens, frames


def test_reduced_config_and_layout_match_reference():
    rcfg, pcfg, host = _setup()
    assert (pcfg.family, pcfg.n_encoder_layers, pcfg.encoder_len,
            pcfg.max_positions) == ("audio", 2, 32, 128)
    params = build_model(pcfg).init_params(torch.Generator().manual_seed(0),
                                           "cpu")
    flat = jax.tree_util.tree_flatten_with_path(host)[0]
    for path, leaf in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert float(params["dec_pos"].std()) < 0.03   # scale 0.02
    shape = InputShape("serve", 24, 2, "prefill")
    want = ref_build(rcfg).batch_shapes(RefShape("serve", 24, 2, "prefill"))
    got = build_model(pcfg).batch_shapes(shape)
    assert list(got) == list(want) == ["frames", "tokens"]
    assert [s for s, _ in got.values()] == [s for s, _ in want.values()]


def test_layer_norm_and_gelu_match_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 256)) * 3 + 1).astype(np.float32)
    w, b = (rng.standard_normal(256).astype(np.float32) for _ in range(2))
    want = ref_common.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b))
    got = port_common.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    assert _err(want, got) < TOL
    want = jax.nn.gelu(jnp.asarray(x))
    got = port_wh._gelu(torch.from_numpy(x))
    assert _err(want, got) < TOL
    # the erf form is not the reference's: the two differ past TOL here
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert _err(want, erf) > TOL


@pytest.mark.parametrize("S_,d", [(32, 256), (1500, 1280)])
def test_sinusoid_matches_reference(S_, d):
    want = ref_wh._sinusoid(S_, d)
    got = port_wh._sinusoid(S_, d)
    assert tuple(got.shape) == (S_, d) and got.dtype == torch.float32
    assert _err(want, got) < TOL


def test_encode_matches_reference():
    rcfg, pcfg, host = _setup()
    _, frames = _inputs(rcfg)
    want = ref_wh.encode(rcfg, host, jnp.asarray(frames))
    got = port_wh.encode(pcfg, params_from_jax(host, device="cpu"),
                         torch.from_numpy(frames))
    assert tuple(got.shape) == (B, rcfg.encoder_len, rcfg.d_model)
    assert _err(want, got) < TOL


def _leaves_close(rcache, pcache, what):
    """Every leaf by ``_close_leaf``; True if the int8 leaves are equal."""
    assert sorted(rcache) == sorted(pcache), what
    same = True
    for name in rcache:
        _close_leaf(rcache[name], pcache[name], f"{what} {name}")
        if pcache[name].dtype == torch.int8:
            same &= np.array_equal(np.asarray(rcache[name]),
                                   pcache[name].numpy())
    return same


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_decode_match_reference(kv_quant):
    """A prompt-sized self cache (as ``JaxEndpoint`` plans it), so every
    decode step writes its last slot. Under ``kv_quant`` each step starts
    from the reference's cache and a step whose new int8 entries land on
    a rounding tie is run again with the reference's entries, as
    ``tests/test_torch_moe.py::check_prefill_and_decode`` does."""
    rcfg, pcfg, host = _setup(kv_quant)
    tokens, frames = _inputs(rcfg)
    params = params_from_jax(host, device="cpu")
    rlogits, rcache = ref_wh.prefill(rcfg, host, jnp.asarray(tokens),
                                     jnp.asarray(frames))
    plogits, pcache = port_wh.prefill(pcfg, params, torch.from_numpy(tokens),
                                      torch.from_numpy(frames))
    assert _err(rlogits, plogits) < TOL
    want = {"k", "v", "ck", "cv"} | ({"k_scale", "v_scale", "ck_scale",
                                      "cv_scale"} if kv_quant else set())
    assert set(pcache) == want
    _leaves_close(rcache, pcache, "prefill")
    rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
    ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
    for i in range(STEPS):
        pos = S + i
        start = rcache
        if kv_quant:
            pcache = _torch_cache(start)
        rlogits, rcache = ref_wh.decode_step(rcfg, host, rcache, rtok, pos)
        plogits, pcache = port_wh.decode_step(pcfg, params, pcache, ptok,
                                              pos)
        if not _leaves_close(rcache, pcache, f"decode {i}"):
            saved = port_tf.attn.quantize_kv
            port_tf.attn.quantize_kv = _with_entries(rcache, S - 1)
            try:
                plogits, pcache = port_wh.decode_step(
                    pcfg, params, _torch_cache(start), ptok, pos)
            finally:
                port_tf.attn.quantize_kv = saved
            assert _leaves_close(rcache, pcache,
                                 f"decode {i}, the reference's entries"), i
        assert _err(rlogits, plogits) < TOL, i
        rtok = jnp.argmax(rlogits, -1)[:, None].astype(jnp.int32)
        ptok = torch.argmax(plogits, -1)[:, None].to(torch.int32)
        assert np.array_equal(np.asarray(rtok), ptok.numpy()), i


def test_forward_matches_reference():
    rcfg, pcfg, host = _setup()
    tokens, frames = _inputs(rcfg, S_text=20)
    want, _ = ref_wh.forward(rcfg, host, jnp.asarray(tokens),
                             jnp.asarray(frames))
    got, aux = port_wh.forward(pcfg, params_from_jax(host, device="cpu"),
                               torch.from_numpy(tokens),
                               torch.from_numpy(frames))
    assert _err(want, got) < TOL and float(aux) == 0.0


def test_decode_matches_forward():
    """The port's prefill of a 6-token prompt and decode of the rest into
    a 20-slot cache reproduce its teacher-forced logits position for
    position (``tests/test_decode_consistency.py``'s check and limit)."""
    _, pcfg, host = _setup(seed=0)
    params = params_from_jax(host, device="cpu")
    tokens, frames = (torch.from_numpy(a)
                      for a in _inputs(pcfg, S_text=20, seed=3))
    full, _ = port_wh.forward(pcfg, params, tokens, frames)
    m = build_model(pcfg)
    prompt, atol = 6, 2e-3
    logits, cache = m.prefill_fn(
        params, {"tokens": tokens[:, :prompt], "frames": frames},
        cache_len=20)
    assert float((logits - full[:, prompt - 1]).abs().max()) < atol
    for t in range(prompt, 20):
        logits, cache = m.decode_fn(params, cache, tokens[:, t:t + 1], t)
        assert float((logits - full[:, t]).abs().max()) < atol, t


def test_decode_past_cache_end_writes_last_slot():
    """A decode step at pos = cache_len writes only the self cache's last
    slot, on both sides, and leaves the cross cache as prefill wrote it."""
    rcfg, pcfg, host = _setup()
    tokens, frames = _inputs(rcfg)
    params = params_from_jax(host, device="cpu")
    _, rcache = ref_wh.prefill(rcfg, host, jnp.asarray(tokens),
                               jnp.asarray(frames))
    _, pcache = port_wh.prefill(pcfg, params, torch.from_numpy(tokens),
                                torch.from_numpy(frames))
    before = {n: t.clone() for n, t in pcache.items()}
    tok = np.full((B, 1), 7, np.int32)
    _, rnext = ref_wh.decode_step(rcfg, host, rcache, jnp.asarray(tok), S)
    _, pnext = port_wh.decode_step(pcfg, params, pcache,
                                   torch.from_numpy(tok), S)
    for name in ("k", "v"):
        changed = (pnext[name] != before[name]).flatten(3).any(-1)
        assert changed[:, :, :S - 1].sum() == 0 and bool(
            changed[:, :, S - 1].all()), name
        assert _err(rnext[name], pnext[name]) < TOL, name
    for name in ("ck", "cv"):
        assert torch.equal(pnext[name], before[name]), name


@pytest.mark.parametrize("pos", [0, 100, 127, 300])
def test_dec_pos_clamps_like_the_reference(pos):
    """``_dec_embed`` slices ``dec_pos`` from ``min(pos, max_positions -
    S)``, as ``dynamic_slice_in_dim`` clamps it: a 1-token step at pos
    127 and at 300 both read the table's last row; a 16-token prompt at
    pos 120 reads rows 112-127."""
    rcfg, pcfg, host = _setup()
    params = params_from_jax(host, device="cpu")
    for n in (1, S):
        tok = np.arange(n, dtype=np.int32)[None].repeat(B, 0)
        want = ref_wh._dec_embed(rcfg, host, jnp.asarray(tok), pos)
        got = port_wh._dec_embed(pcfg, params, torch.from_numpy(tok), pos)
        assert _err(want, got) < 1e-7, (pos, n)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    last = port_wh._dec_embed(pcfg, params, tok, 300) - params["emb"][0]
    assert torch.allclose(last[0, 0], params["dec_pos"][-1])


def test_endpoint_greedy_tokens_match_jax_endpoint():
    """Both endpoints on the reference's weights; the port's batch for a
    request (frames, then tokens) is the reference's, through numpy; the
    decode starts at the prompt's length (frames shift no position)."""
    rcfg, pcfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    kw = dict(seed=2, serve_seq=24, serve_batch=2, decode_steps=4)
    jep = JaxEndpoint("ref", rcfg, **kw)
    tep = TorchEndpoint("port", pcfg, device="cpu", **kw)
    assert tep.plan == decode_cache_plan(pcfg, 24)
    assert (tep.plan.kind, tep.plan.length) == ("full", 24)
    tep.host_params = params_from_jax(jep.host_params, device="cpu")
    assert tep.weight_bytes == jep.weight_bytes

    def jax_batch(shape, generator, device):
        rb = jep.model.make_batch(
            shape, rng=jax.random.PRNGKey(generator.initial_seed()))
        return {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    tep.model.make_batch = jax_batch
    for ep in (jep, tep):
        ep.upload()
        ep.compile()
    for seed in (0, 5):
        want = jep.execute({"seed": seed})["tokens"]
        got = tep.execute({"seed": seed})["tokens"]
        assert got.shape == want.shape == (2, 4)
        assert np.array_equal(got, want), (seed, got, want)


def test_make_batch_draws_frames():
    pcfg = get_config(ARCH).reduced()
    m = build_model(pcfg)
    batch = m.make_batch(InputShape("serve", 24, 2, "prefill"),
                         torch.Generator().manual_seed(0), "cpu")
    assert tuple(batch["frames"].shape) == (2, pcfg.encoder_len,
                                            pcfg.d_model)
    assert batch["frames"].dtype == torch.float32
    assert 0.01 < float(batch["frames"].std()) < 0.03
    assert tuple(batch["tokens"].shape) == (2, 24)
    assert m.decode_start(batch) == 24


def test_plain_prefill_chunk_rule_with_fewer_keys():
    """``PLAIN_OPS.prefill`` with Sq != Sk: above 2 * PREFILL_CHUNK query
    positions it attends in query chunks over all Sk keys (the
    reference's rule, ``repro/models/whisper.py:89-92``), the same
    function as K1's plain version; Sq 3000 (not a multiple of the
    chunk) falls back to one block."""
    from repro_torch.kernels.flash_attention import ops as fl
    g = torch.Generator().manual_seed(4)
    for Sq in (3072, 3000):
        q = torch.randn(1, Sq, 2, 16, generator=g)
        k, v = (torch.randn(1, 1500, 2, 16, generator=g) for _ in range(2))
        got = port_tf.PLAIN_OPS.prefill(q, k, v, causal=False, window=0)
        want = fl.flash_attention_plain(q, k, v, causal=False)
        assert float((got - want).abs().max()) < 2e-5, Sq
