"""Plain versions of the port's kernels K1-K3 against the reference.

Each plain PyTorch version (the CPU path of the kernel wrapper, and the
yardstick the CUDA kernel is held against on the card) is held against
the Pallas kernel of ``repro.kernels`` in interpret mode, as
``tests/test_kernels.py`` runs it, and against ``repro.models.attention``.
Same sweep as ``tests/test_kernels.py``. Tolerances: 2e-5 for float32,
2e-2 for bfloat16; the transcription of K3's bf16 arithmetic
(``decode_attention_quant_as_kernel``) within 2**-6 of each output row's
largest value. ``decode_sm90_plain``, the transcription of K2's and K3's
Hopper kernel (its tiles, warps and rank-order merge under a plan), is
held to the plain versions, the Pallas kernels and K3's transcription at
the same tolerances. Inputs come from numpy with a seed.

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


@pytest.mark.parametrize("Sq,Sk", [(1, 100), (7, 100), (40, 100),
                                   (150, 100)])
@pytest.mark.parametrize("H,KV,dh", [(4, 4, 64), (4, 2, 32)])
def test_flash_plain_cross_vs_pallas_and_model(Sq, Sk, H, KV, dh):
    """Non-causal with Sq != Sk (Whisper's cross-attention): queries at
    0..Sq-1 over keys at 0..Sk-1, fewer queries than keys and more."""
    rng = np.random.default_rng(Sq * 100 + Sk + dh)
    B = 2
    q = _normal(rng, (B, Sq, H, dh))
    k, v = _normal(rng, (B, Sk, KV, dh)), _normal(rng, (B, Sk, KV, dh))
    out = fl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=False)
    assert out.shape == (B, Sq, H, dh) and out.dtype == torch.float32
    pal = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=False)
    model = ref_attn.masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(Sq),
        jnp.arange(Sk), causal=False)
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


# --- launch planning of the decode kernels (pure Python, no card) ----------

PLAN_SHAPES = [(4, 1024, 8), (4, 1024, 5), (8, 1024, 8), (16, 1024, 4),
               (1, 1, 1), (1, 31, 2), (1, 32, 1), (2, 33, 4), (1, 65, 1),
               (1, 100, 2), (3, 257, 5), (3, 300, 5), (2, 4096, 8),
               (1, 1000, 1)]


def _ranges(n, chunk, S):
    return [range(r * chunk, min(S, (r + 1) * chunk)) for r in range(n)]


@pytest.mark.parametrize("B,S,KV", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_k2_cluster_plan_covers_every_slot_once(B, S, KV, sms):
    n, chunk = dec.cluster_plan(B, S, KV, sms)
    assert 1 <= n <= dec.MAX_CLUSTER
    ranges = _ranges(n, chunk, S)
    assert [s for r in ranges for s in r] == list(range(S))
    assert all(len(r) > 0 for r in ranges)
    if S >= dec.SLOT_TILE:
        assert chunk >= dec.SLOT_TILE


@pytest.mark.parametrize("B,S,KV", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_k3_split_plan_covers_every_slot_once(B, S, KV, sms):
    """K3's launch plan (``quant_plan``, one cluster per (batch, kv head)
    row) splits the slots among at most MAX_CLUSTER CTAs."""
    n, chunk = dec.quant_plan(B, S, KV, sms)
    assert 1 <= n <= dec.MAX_CLUSTER
    ranges = _ranges(n, chunk, S)
    assert [s for r in ranges for s in r] == list(range(S))
    assert all(len(r) > 0 for r in ranges)
    if S >= dec.SLOT_TILE:
        assert chunk >= dec.SLOT_TILE


def test_k2_cluster_plan_at_serving_shapes():
    """qwen3-1.7b (B 4, KV 8) and hymba-1.5b (B 4, KV 5) over 1024 slots on
    the H100's 132 SMs: full clusters of 8 CTAs of 128 slots (four warp
    tiles each)."""
    assert dec.cluster_plan(4, 1024, 8, 132) == (8, 128)
    assert dec.cluster_plan(4, 1024, 5, 132) == (8, 128)
    # B*KV = 64 rows: 5 CTAs a row fill the card twice over
    assert dec.cluster_plan(8, 1024, 8, 132) == (5, 205)


def test_k3_plan_at_serving_shapes():
    """K3 over qwen3-1.7b's (B 4, KV 8) and hymba-1.5b's (B 4, KV 5) 1024
    slots on 132 SMs: full clusters of 8 CTAs of 128 slots, as K2; at
    B*KV = 64 rows its higher target of CTAs per SM keeps 8 CTAs a row
    where K2 takes 5."""
    assert dec.quant_plan(4, 1024, 8, 132) == (8, 128)
    assert dec.quant_plan(4, 1024, 5, 132) == (8, 128)
    assert dec.quant_plan(8, 1024, 8, 132) == (8, 128)


@pytest.mark.parametrize("G,n_sub", [(1, 1), (2, 1), (5, 1), (8, 1), (9, 3),
                                     (11, 11), (12, 2), (16, 2), (32, 4)])
def test_k2_sub_groups_cover_the_group(G, n_sub):
    """K2 takes a group of at most MAX_GROUP query heads a launch; a larger
    group splits into the fewest equal sub-groups that fit."""
    assert dec.sub_groups(G) == n_sub
    assert G % n_sub == 0 and G // n_sub <= dec.MAX_GROUP


@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos", [
    (2, 64, 32, 2, 128, 0, False, 70),   # chatglm3-6b's heads, G 16
    (1, 96, 18, 2, 64, 32, True, 150),   # G 9: three sub-groups of 3
    (2, 48, 24, 2, 32, 0, True, 40),     # G 12: two sub-groups of 6
    (2, 40, 16, 1, 64, 0, True, 90),     # G 16 over one kv head
])
def test_k2_sub_group_split_matches_pallas(B, S, H, KV, dh, window, ring,
                                           pos):
    """K2 runs a large group as ``sub_groups`` launches, launch i over
    query heads kv * G + q0 .. kv * G + q0 + g - 1 of every kv head (q0 =
    i * g), each attending as a group of g heads over the same cache. Those
    launches, here each through the plain version on the gathered heads,
    cover every head once and give the reference's decode attention over
    the whole group."""
    rng = np.random.default_rng(H + dh + pos)
    q = _normal(rng, (B, 1, H, dh))
    ck, cv = _normal(rng, (B, S, KV, dh)), _normal(rng, (B, S, KV, dh))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, ck, cv))
    G = H // KV
    g = G // dec.sub_groups(G)
    assert g <= dec.MAX_GROUP
    out = torch.full_like(tq, float("nan"))
    for q0 in range(0, G, g):
        heads = [kv * G + q0 + i for kv in range(KV) for i in range(g)]
        out[:, :, heads] = dec.decode_attention_plain(
            tq[:, :, heads].contiguous(), tk, tv, pos, window=window,
            ring=ring)
    assert not torch.isnan(out).any()
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), pos)
    assert _diff(out, pallas_decode(*jargs, window=window, ring=ring)) < 2e-5


def _q8_inputs(rng, B, S, H, KV, dh):
    """q and an int8 cache with its scales, quantized by the reference so
    that both sides read the same bytes."""
    q = _normal(rng, (B, 1, H, dh))
    ck, cks = (np.array(a) for a in ref_attn.quantize_kv(
        jnp.asarray(_normal(rng, (B, S, KV, dh)))))
    cv, cvs = (np.array(a) for a in ref_attn.quantize_kv(
        jnp.asarray(_normal(rng, (B, S, KV, dh)))))
    return q, ck, cks, cv, cvs


@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos", [
    (2, 64, 32, 2, 128, 0, False, 70),   # chatglm3-6b's heads, G 16
    (1, 96, 18, 2, 64, 32, True, 150),   # G 9: three sub-groups of 3
    (2, 48, 24, 2, 32, 0, True, 40),     # G 12: two sub-groups of 6
    (2, 40, 16, 1, 64, 0, True, 90),     # G 16 over one kv head
])
def test_k3_sub_group_split_matches_pallas(B, S, H, KV, dh, window, ring,
                                           pos):
    """K3 runs a large group as K2 does, one launch per sub-group of g
    query heads of every kv head; those launches, here each through the
    plain version on the gathered heads, give the Pallas int8 kernel's
    decode attention over the whole group."""
    rng = np.random.default_rng(11 + H + dh + pos)
    q, ck, cks, cv, cvs = _q8_inputs(rng, B, S, H, KV, dh)
    tq = torch.from_numpy(q)
    cache = [torch.from_numpy(a) for a in (ck, cks, cv, cvs)]
    G = H // KV
    g = G // dec.sub_groups(G)
    assert g <= dec.MAX_GROUP
    out = torch.full_like(tq, float("nan"))
    for q0 in range(0, G, g):
        heads = [kv * G + q0 + i for kv in range(KV) for i in range(g)]
        out[:, :, heads] = dec.decode_attention_quant_plain(
            tq[:, :, heads].contiguous(), *cache, pos, window=window,
            ring=ring)
    assert not torch.isnan(out).any()
    pal = pallas_q8(*(jnp.asarray(a) for a in (q, ck, cks, cv, cvs)), pos,
                    window=window, ring=ring)
    assert _diff(out, pal) < 2e-5


def _row_rel(a, b) -> float:
    """max over rows of max|a - b| in the row over max|b| in the row"""
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(jnp.asarray(b, jnp.float32))
    d = np.abs(a - b).max(-1)
    return float((d / np.maximum(np.abs(b).max(-1), 1e-30)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos", DECODE_CASES)
def test_k3_kernel_arithmetic_matches_pallas_and_oracle(
        dtype, B, S, H, KV, dh, window, ring, pos):
    """``decode_attention_quant_as_kernel`` transcribes the CUDA kernel's
    arithmetic (int8 exact in bf16, the k scale on the f32 scores, p times
    the v scale rounded to bf16 for a bf16 q). It computes the Pallas
    int8 kernel's function and ``decode_attention_q8_ref``'s: within 2e-5
    in float32, and in bfloat16 within 2**-6 of each row's largest value
    (both round the output to bf16; the oracle also rounds the dequantised
    cache and p to bf16)."""
    rng = np.random.default_rng(5 + S + dh + pos)
    q, ck, cks, cv, cvs = _q8_inputs(rng, B, S, H, KV, dh)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = dec.decode_attention_quant_as_kernel(
        torch.from_numpy(q).to(tdt), *(torch.from_numpy(a)
                                       for a in (ck, cks, cv, cvs)),
        pos, window=window, ring=ring)
    assert out.dtype == tdt and out.shape == (B, 1, H, dh)
    jq = jnp.asarray(q, jdt)
    pal = pallas_q8(jq, *(jnp.asarray(a) for a in (ck, cks, cv, cvs)), pos,
                    window=window, ring=ring)
    G = H // KV
    fold = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(
        B * KV, S, dh)
    fold_s = lambda a: jnp.asarray(a).transpose(0, 2, 1).reshape(B * KV, S)
    slot_pos = (ref_attn.ring_slot_positions(pos + 1, S) if ring else
                jnp.where(jnp.arange(S) <= pos, jnp.arange(S), -1))
    oracle = decode_attention_q8_ref(
        jq.reshape(B * KV, G, dh), fold(ck), fold_s(cks), fold(cv),
        fold_s(cvs), pos, slot_pos, window=window).reshape(B, 1, H, dh)
    if tdt == torch.float32:
        assert _diff(out, pal) < 2e-5
        assert _diff(out, oracle) < 2e-5
    else:
        assert _row_rel(out, pal) <= 2.0 ** -6
        assert _row_rel(out, oracle) <= 2.0 ** -6


@pytest.mark.parametrize("B,S,KV,k2,k3", [
    (4, 1500, 20, (4, 375), (7, 215)),   # whisper-large-v3's cross cache
    (4, 432, 20, (4, 108), (7, 62)),     # its self cache
    (4, 1024, 8, (8, 128), (8, 128)),    # qwen3-1.7b's, on the tile
])
def test_cluster_plans_at_whisper_caches(B, S, KV, k2, k3):
    """K2's and K3's launch plans on the H100's 132 SMs: at Whisper's
    caches each CTA's chunk ends mid-tile (not a multiple of SLOT_TILE),
    K3's in a cluster of 7; every slot is covered, every CTA's range is
    non-empty."""
    for plan, want in ((dec.cluster_plan, k2), (dec.quant_plan, k3)):
        n, chunk = plan(B, S, KV, 132)
        assert (n, chunk) == want
        assert (n - 1) * chunk < S <= n * chunk
    if S != 1024:
        assert k2[1] % dec.SLOT_TILE and k3[1] % dec.SLOT_TILE


# --- the Hopper kernel's split and merge order (decode_sm90) --------------

# (B, S, H, KV, dh, window, ring, pos, n_ctas, chunk, stages): G 16; a
# wrapped ring under a window; CTA ranges that end mid-tile (chunk not a
# multiple of the 32-slot tile); ranks with no valid slot (a full cache
# early in decode); a CTA with more tiles than warps (two rounds of the
# warps); rings shallower than a CTA's tiles (stage s to warp s % 4: 1 and
# 3 stages leave warps idle, 6 give two warps twice the tiles of the
# others); stages 0 is a ring as deep as the CTA's tiles
SM90_CASES = [
    (2, 64, 32, 2, 128, 0, False, 70, 2, 32, 0),
    (2, 64, 8, 2, 64, 16, True, 200, 2, 32, 0),
    (2, 100, 4, 2, 64, 48, False, 90, 4, 25, 0),
    (1, 100, 4, 1, 128, 0, True, 150, 3, 40, 0),
    (2, 128, 8, 2, 64, 0, False, 40, 4, 32, 0),
    (1, 300, 6, 3, 64, 0, False, 299, 1, 300, 0),
    (1, 300, 6, 3, 64, 0, False, 299, 1, 300, 1),
    (1, 300, 6, 3, 64, 0, False, 299, 1, 300, 3),
    (1, 500, 32, 2, 64, 0, True, 640, 1, 512, 6),
]


@pytest.mark.parametrize(
    "B,S,H,KV,dh,window,ring,pos,n_ctas,chunk,stages", SM90_CASES)
def test_sm90_split_and_merge_match_plain_and_pallas(B, S, H, KV, dh, window,
                                                     ring, pos, n_ctas,
                                                     chunk, stages):
    """``decode_sm90_plain`` (the Hopper kernel's tiles, warps, CTA merge
    and rank-order cluster merge) in float32 gives K2's function: within
    2e-5 of the plain version and of the Pallas kernel (interpret); in
    bfloat16 (p rounded for P.V as the kernel rounds it) within 2**-6 of
    each row's largest value of the plain version."""
    rng = np.random.default_rng(31 + S + dh + pos)
    q = _normal(rng, (B, 1, H, dh))
    ck, cv = _normal(rng, (B, S, KV, dh)), _normal(rng, (B, S, KV, dh))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, ck, cv))
    kw = dict(window=window, ring=ring)
    out = dec.decode_sm90_plain(tq, tk, tv, pos, n_ctas=n_ctas, chunk=chunk,
                                stages=stages, **kw)
    assert out.shape == (B, 1, H, dh) and out.dtype == torch.float32
    assert _diff(out, dec.decode_attention_plain(tq, tk, tv, pos, **kw)) \
        < 2e-5
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), pos)
    assert _diff(out, pallas_decode(*jargs, **kw)) < 2e-5
    bq, bk, bv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    out = dec.decode_sm90_plain(bq, bk, bv, pos, n_ctas=n_ctas, chunk=chunk,
                                stages=stages, **kw)
    assert out.dtype == torch.bfloat16
    assert _row_rel(out, dec.decode_attention_plain(bq, bk, bv, pos, **kw)) \
        <= 2.0 ** -6


@pytest.mark.parametrize(
    "B,S,H,KV,dh,window,ring,pos,n_ctas,chunk,stages", SM90_CASES)
def test_sm90_split_and_merge_match_k3_arithmetic(B, S, H, KV, dh, window,
                                                  ring, pos, n_ctas, chunk,
                                                  stages):
    """K3 through ``decode_sm90_plain`` (k scale on the f32 scores, p
    times the v scale): in float32 within 2e-5 of
    ``decode_attention_quant_as_kernel`` and of the Pallas int8 kernel
    (interpret); in bfloat16 within 2**-6 of each row's largest value of
    ``decode_attention_quant_as_kernel``, which rounds p times the v scale
    to bf16 as both do."""
    rng = np.random.default_rng(37 + S + dh + pos)
    q, ck, cks, cv, cvs = _q8_inputs(rng, B, S, H, KV, dh)
    cache = [torch.from_numpy(a) for a in (ck, cks, cv, cvs)]
    kw = dict(window=window, ring=ring)
    for dtype in (torch.float32, torch.bfloat16):
        tq = torch.from_numpy(q).to(dtype)
        out = dec.decode_sm90_plain(tq, cache[0], cache[2], pos,
                                    n_ctas=n_ctas, chunk=chunk,
                                    stages=stages, k_scale=cache[1],
                                    v_scale=cache[3], **kw)
        ref = dec.decode_attention_quant_as_kernel(tq, *cache, pos, **kw)
        assert out.dtype == dtype
        if dtype == torch.float32:
            assert _diff(out, ref) < 2e-5
            pal = pallas_q8(*(jnp.asarray(a) for a in (q, ck, cks, cv, cvs)),
                            pos, **kw)
            assert _diff(out, pal) < 2e-5
        else:
            assert _row_rel(out, ref) <= 2.0 ** -6
