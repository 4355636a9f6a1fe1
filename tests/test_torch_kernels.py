"""Plain versions of the port's kernels K1-K3 against the reference.

Each plain PyTorch version (the CPU path of the kernel wrapper, and the
yardstick the CUDA kernel is held against on the card) is held against
the Pallas kernel of ``repro.kernels`` in interpret mode, as
``tests/test_kernels.py`` runs it, and against ``repro.models.attention``.
Same sweep as ``tests/test_kernels.py``. Tolerances: 2e-5 for float32,
2e-2 for bfloat16. Inputs come from numpy with a seed.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as pallas_decode, decode_attention_quant as pallas_q8)
from repro.kernels.decode_attention.ref import decode_attention_q8_ref  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as pallas_flash  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _diff(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(jnp.asarray(b, jnp.float32))
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("B,S,H,KV,dh", [
    (2, 256, 4, 2, 64), (1, 128, 4, 4, 32), (2, 192, 8, 2, 128),
    (1, 96, 3, 1, 64), (1, 64, 2, 2, 256), (1, 200, 2, 2, 64),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_flash_plain_vs_pallas_and_model(B, S, H, KV, dh, causal, window):
    rng = np.random.default_rng(B * 1000 + S + dh)
    q, k, v = (_normal(rng, (B, S, n, dh)) for n in (H, KV, KV))
    out = fl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window)
    assert out.shape == (B, S, H, dh) and out.dtype == torch.float32
    pal = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window)
    model = ref_attn.masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(S),
        jnp.arange(S), causal=causal, window=window)
    assert _diff(out, pal) < 2e-5
    assert _diff(out, model) < 2e-5


def test_flash_plain_bf16():
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, (1, 128, n, 64)) for n in (4, 2, 2))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    out = fl.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    assert _diff(out, pallas_flash(jq, jk, jv)) < 2e-2
    assert _diff(out, ref_attn.masked_attention(
        jq, jk, jv, jnp.arange(128), jnp.arange(128))) < 2e-2


DECODE_CASES = [
    (2, 256, 4, 2, 64, 0, False, 100),
    (1, 128, 8, 8, 32, 0, False, 127),
    (2, 64, 4, 1, 64, 48, True, 200),
    (1, 512, 6, 2, 128, 0, False, 5),
    (1, 96, 5, 5, 64, 32, True, 96),
    (2, 64, 4, 2, 256, 0, False, 70),   # full cache, pos past its end
]


@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos", DECODE_CASES)
def test_decode_plain_vs_pallas_and_model(B, S, H, KV, dh, window, ring,
                                          pos):
    rng = np.random.default_rng(S + dh + pos)
    q = _normal(rng, (B, 1, H, dh))
    ck, cv = _normal(rng, (B, S, KV, dh)), _normal(rng, (B, S, KV, dh))
    out = dec.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                               torch.from_numpy(cv), pos, window=window,
                               ring=ring)
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), pos)
    assert _diff(out, pallas_decode(*jargs, window=window, ring=ring)) < 2e-5
    assert _diff(out, ref_attn.decode_attention(
        *jargs, window=window, ring=ring)) < 2e-5


@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos", DECODE_CASES)
def test_decode_q8_plain_vs_pallas_and_oracle(B, S, H, KV, dh, window, ring,
                                              pos):
    rng = np.random.default_rng(7 + S + dh + pos)
    q = _normal(rng, (B, 1, H, dh))
    ckf, cvf = _normal(rng, (B, S, KV, dh)), _normal(rng, (B, S, KV, dh))
    # quantize with the reference, so both sides read the same int8 cache
    ck, cks = (np.array(a) for a in ref_attn.quantize_kv(jnp.asarray(ckf)))
    cv, cvs = (np.array(a) for a in ref_attn.quantize_kv(jnp.asarray(cvf)))
    out = dec.decode_attention_quant(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cks),
        torch.from_numpy(cv), torch.from_numpy(cvs), pos, window=window,
        ring=ring)
    pal = pallas_q8(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cks),
                    jnp.asarray(cv), jnp.asarray(cvs), pos, window=window,
                    ring=ring)
    assert _diff(out, pal) < 2e-5
    G = H // KV
    fold = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(
        B * KV, S, dh)
    fold_s = lambda a: jnp.asarray(a).transpose(0, 2, 1).reshape(B * KV, S)
    slot_pos = (ref_attn.ring_slot_positions(pos + 1, S) if ring else
                jnp.where(jnp.arange(S) <= pos, jnp.arange(S), -1))
    oracle = decode_attention_q8_ref(
        jnp.asarray(q).reshape(B * KV, G, dh), fold(ck), fold_s(cks),
        fold(cv), fold_s(cvs), pos, slot_pos, window=window)
    assert _diff(out, oracle.reshape(B, 1, H, dh)) < 2e-5
    # and against full precision, as test_kernels.py bounds it
    full = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(ckf),
                                     jnp.asarray(cvf), pos, window=window,
                                     ring=ring)
    assert _diff(out, full) < 0.05


@pytest.mark.parametrize("pos,W", [(0, 8), (5, 8), (8, 8), (21, 8), (3, 1)])
def test_slot_positions_match_reference(pos, W):
    assert port_attn.ring_slot_positions(pos, W).tolist() == \
        np.asarray(ref_attn.ring_slot_positions(pos, W)).tolist()


def test_quantize_kv_matches_reference():
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 9, 3, 64)) * 10.0
    q, s = port_attn.quantize_kv(torch.from_numpy(x))
    rq, rs = ref_attn.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert _diff(s, rs) == 0.0
    assert _diff(port_attn.dequantize_kv(q, s, torch.float32),
                 ref_attn.dequantize_kv(rq, rs, jnp.float32)) < 1e-6
