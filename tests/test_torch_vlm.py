"""The port's VLM (llava-next-mistral-7b), its other dense configs and its
chunked prefill attention against ``repro``, on the reference's own
weights and inputs.

Reduced llava-next-mistral-7b (float32, 8 patch embeddings, window 64) at
S 96: the prefill masks by the window and fills a 64-slot ring, and the
decode steps, at positions 96 on (after the patches and the tokens), wrap
it. Reduced chatglm3-6b (rope on half of each head), qwen1.5-32b (q, k, v
biases, drawn from a seed: the reference initialises them to zero) and
deepseek-coder-33b: prefill and decode. Each with ``kv_quant`` off and on,
held by ``tests/test_torch_moe.py``'s ``check_prefill_and_decode``.

``TorchEndpoint`` (on the CPU) and ``JaxEndpoint`` on the same weights
and the same request batches give equal greedy tokens, for reduced llava
and reduced granite-moe-3b-a800m: the endpoint's decode must start at
``s_text + n_patches`` for a VLM, as ``JaxEndpoint``'s does.

``chunked_attention`` against the reference's at S 3072 (three query
chunks of 1024) and S 3000 (not a multiple of the chunk: one block), and
the plain prefill's chunk rule against K1's plain version.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.runtime.device import JaxEndpoint  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import decode_cache_plan  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.runtime.device import TorchEndpoint  # noqa: E402
from test_torch_moe import _err, _setup, check_prefill_and_decode  # noqa: E402,E501

TOL = 1e-4
LLAVA = "llava-next-mistral-7b"


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_llava_prefill_and_ring_decode_match_reference(kv_quant):
    rcfg, pcfg, host = _setup(LLAVA, kv_quant)
    S, B = 96, 2
    n_p = pcfg.n_patches
    plan = decode_cache_plan(pcfg, S)
    assert (n_p, plan.kind, plan.length) == (8, "ring", 64)
    assert pcfg.sliding_window == 64 < S
    patches = (np.random.default_rng(7).standard_normal(
        (B, n_p, pcfg.d_model)) * 0.02).astype(np.float32)
    check_prefill_and_decode(rcfg, pcfg, host, _tokens(rcfg, B, S - n_p, 8),
                             patch_embeds=patches, cache_len=plan.length,
                             ring=True)


def _qkv_biases(host, seed):
    """q, k, v biases drawn from a seed (the reference initialises them to
    zero, which would not show a fault in their use)."""
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        b = host["layers"][name]
        host["layers"][name] = (rng.standard_normal(b.shape) * 0.5
                                ).astype(b.dtype)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen1.5-32b",
                                  "deepseek-coder-33b"])
def test_dense_configs_match_reference(arch, kv_quant):
    rcfg, pcfg, host = _setup(arch, kv_quant)
    if pcfg.qkv_bias:
        _qkv_biases(host, 9)
    assert (pcfg.rope_2d, pcfg.qkv_bias) == (
        arch == "chatglm3-6b", arch == "qwen1.5-32b")
    check_prefill_and_decode(rcfg, pcfg, host, _tokens(rcfg, 2, 24, 5))


@pytest.mark.parametrize("arch,serve_seq", [(LLAVA, 96),
                                            ("granite-moe-3b-a800m", 64)])
def test_endpoint_greedy_tokens_match_jax_endpoint(arch, serve_seq):
    """Both endpoints on the reference's weights; the port's batch for a
    request is the reference's (``make_batch`` under the request's seed),
    passed through numpy."""
    rcfg, pcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(seed=2, serve_seq=serve_seq, serve_batch=2, decode_steps=4)
    jep = JaxEndpoint("ref", rcfg, **kw)
    tep = TorchEndpoint("port", pcfg, device="cpu", **kw)
    tep.host_params = params_from_jax(jep.host_params, device="cpu")

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


@pytest.mark.parametrize("S,causal,window", [(3072, True, 0),
                                             (3072, True, 700),
                                             (3072, False, 0),
                                             (3000, True, 0)])
def test_chunked_attention_matches_reference(S, causal, window):
    rng = np.random.default_rng(11)
    B, H, KV, dh = 1, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, n, dh)).astype(np.float32)
               for n in (H, KV, KV))
    pos = np.arange(S)
    want = ref_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), causal=causal, window=window, chunk=1024)
    t = torch.from_numpy
    got = port_attn.chunked_attention(t(q), t(k), t(v), t(pos), t(pos),
                                      causal=causal, window=window,
                                      chunk=1024)
    assert _err(want, got) < 2e-5


def test_plain_prefill_chunk_rule():
    """Above 2 * PREFILL_CHUNK positions the plain prefill attends in
    query chunks: the same function as K1's plain version; at and below
    it, K1's plain version itself."""
    assert port_tf.PREFILL_CHUNK == 1024
    g = torch.Generator().manual_seed(3)
    for S, window in [(3072, 0), (3072, 2500), (2048, 0)]:
        q, k, v = (torch.randn(1, S, n, 16, generator=g) for n in (4, 2, 2))
        got = port_tf.PLAIN_OPS.prefill(q, k, v, causal=True, window=window)
        want = fl.flash_attention_plain(q, k, v, causal=True, window=window)
        assert float((got - want).abs().max()) < 2e-5, (S, window)
