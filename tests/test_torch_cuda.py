"""The port's CUDA kernels K1-K5 against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where no CUDA card
is present. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 for float32 (summation order only; K1's float32 kernel
runs on the CUDA cores, not in TF32), 2e-2 for bfloat16; K2 above 8
query heads per kv head and K3's edge cases in bfloat16 within 2**-6 of
each output row's largest value;
for the mLSTM scan (K4, float32 only) and the SSM scan (K5), whose
states sum S steps, the largest |difference| in a row over the row's
largest |plain value| at most 1e-4 in float32; K5's bfloat16 y, rounded
from float32 on both sides, at most 2**-6 (a rounding flip is at most
one ulp, 2**-7 of the row's largest value). The MoE layer on the card:
two runs give the same bits, bf16 within 2e-2 of the float32 experts'
largest value on the same routing, float32 within 2e-5 of the CPU's.
At Whisper's shapes (K1 non-causal with Sq != Sk, K2/K3 over its cross
and self caches) bfloat16 rows within 2**-6 of each row's largest value,
float32 within 2e-5. Training: each wrapper refuses a CUDA input that
requires grad before any launch; reduced qwen3 and granite-moe (float32)
give the CPU's loss within 1e-5 relative and its grads within 1e-4 of
each leaf's largest |g|, launching no kernel; a checkpoint saved from
the card restores onto it with the same bits. The batch simulator's
lanes on the card give the CPU's run bit for bit.
This file imports no JAX, so it runs where JAX is absent.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.decode_attention import ops as dec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as k4  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as k5  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe  # noqa: E402

pytestmark = pytest.mark.cuda
DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _check_flash(gen, dtype, B, S, H, KV, dh, causal, window):
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, S, n, dh, generator=gen, device="cuda",
                           dtype=dt) for n in (H, KV, KV))
    before = fl.flash_attention.launches
    out = fl.flash_attention(q, k, v, causal=causal, window=window)
    ref = fl.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fl.flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    assert _err(out, ref) < _tol(dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,dh", [
    (2, 256, 4, 2, 64), (1, 128, 4, 4, 32), (2, 192, 8, 2, 128),
    (1, 96, 3, 1, 64), (1, 64, 2, 2, 256), (1, 200, 2, 2, 64),
    (2, 1024, 16, 8, 128), (1, 300, 25, 5, 64), (2, 300, 8, 2, 128),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (True, 1024), (False, 0)])
def test_flash_kernel_vs_plain(gen, dtype, B, S, H, KV, dh, causal, window):
    _check_flash(gen, dtype, B, S, H, KV, dh, causal, window)


# K1's tile edges: bf16 query tiles of 64 rows a warpgroup, 128 rows and
# 128-key blocks at dh 128, 192 rows and 112-key blocks at dh 64; at dh 32
# and 256 query blocks of 64 rows and key blocks of 64 (32 at dh 256); f32
# query blocks of 64 and key blocks of 32
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [1, 15, 17, 63, 64, 65, 127, 129, 200, 1000,
                               111, 112, 113, 128, 191, 192, 193, 1500])
def test_flash_kernel_tile_edges(gen, dtype, dh, S):
    _check_flash(gen, dtype, 1, S, 4, 2, dh, True, 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("window", [1, 63, 64, 65, 112, 127, 128, 129])
def test_flash_kernel_window_edges(gen, dtype, dh, window):
    _check_flash(gen, dtype, 2, 200, 4, 2, dh, True, window)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G", [1, 2, 5, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_gqa_groups(gen, dtype, G, causal):
    _check_flash(gen, dtype, 2, 129, 2 * G, 2, 64, causal, 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [1, 65, 200])
def test_flash_kernel_non_causal(gen, dtype, dh, S):
    _check_flash(gen, dtype, 2, S, 4, 2, dh, False, 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,dh,window", [
    (4, 1024, 24, 8, 64, 0),         # granite-moe-3b-a800m's prefill
    (4, 4096, 32, 8, 128, 4096),     # llava's: a window that never masks
])
def test_flash_kernel_at_new_serving_shapes(gen, dtype, B, S, H, KV, dh,
                                            window):
    _check_flash(gen, dtype, B, S, H, KV, dh, True, window)


DECODE_CASES = [
    (2, 256, 4, 2, 64, 0, False, 100),
    (1, 128, 8, 8, 32, 0, False, 127),
    (2, 64, 4, 1, 64, 48, True, 200),
    (1, 512, 6, 2, 128, 0, False, 5),
    (1, 96, 5, 5, 64, 32, True, 96),
    (2, 128, 4, 2, 64, 0, True, 40),
    (2, 64, 4, 2, 256, 0, False, 70),
    (4, 1024, 16, 8, 128, 0, False, 1039),
    (4, 1024, 16, 8, 128, 256, True, 3089),
    # hymba-1.5b: G = 5, dh 64, its serving ring (window = ring = 1024)
    # after 16 decode steps, and a wrapped ring under a shorter window
    (4, 1024, 25, 5, 64, 1024, True, 1039),
    (2, 64, 25, 5, 64, 16, True, 200),
    # llava-next-mistral-7b: its 4096-slot ring (window = ring) after 16
    # decode steps, slot 15 holding position 4111 (512 slots a CTA, many
    # tiles a warp)
    (4, 4096, 32, 8, 128, 4096, True, 4111),
    # granite-moe-3b-a800m's full cache (G 3, dh 64), the query past its
    # end; deepseek-coder-33b's heads (G 7) and qwen1.5-32b's (G 1, 40 kv
    # heads)
    (4, 1024, 24, 8, 64, 0, False, 1039),
    (4, 1024, 56, 8, 128, 0, False, 1039),
    (4, 1024, 40, 40, 128, 0, False, 1039),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos", DECODE_CASES)
def test_decode_kernels_vs_plain(gen, dtype, B, S, H, KV, dh, window, ring,
                                 pos):
    dt = getattr(torch, dtype)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda", dtype=dt)
    q, ck, cv = r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh)
    before = dec.decode_attention.launches
    out = dec.decode_attention(q, ck, cv, pos, window=window, ring=ring)
    ref = dec.decode_attention_plain(q, ck, cv, pos, window=window,
                                     ring=ring)
    torch.cuda.synchronize()
    assert dec.decode_attention.launches == before + 1
    assert out.dtype == dt and _err(out, ref) < _tol(dt)
    k8, ks = attn.quantize_kv(ck)
    v8, vs = attn.quantize_kv(cv)
    out = dec.decode_attention_quant(q, k8, ks, v8, vs, pos, window=window,
                                     ring=ring)
    ref = dec.decode_attention_quant_plain(q, k8, ks, v8, vs, pos,
                                           window=window, ring=ring)
    torch.cuda.synchronize()
    assert out.dtype == dt and _err(out, ref) < _tol(dt)


# K2's edges: clusters of up to 8 CTAs (decode_cluster) or 16
# (decode_sm90), tiles of 32 slots
K2_EDGE_CASES = [
    # a full cache at pos 0, 1 and 31: most of a cluster has no valid slot
    (2, 1024, 16, 8, 128, 0, False, 0),
    (2, 1024, 16, 8, 128, 0, False, 1),
    (2, 1024, 16, 8, 128, 0, False, 31),
    # S not a multiple of the slot tile
    (2, 100, 4, 2, 64, 0, False, 150),
    (1, 1000, 4, 1, 128, 0, True, 1500),
    (3, 257, 10, 5, 64, 0, False, 200),
    # a wrapped ring under window 1: one valid slot
    (2, 64, 4, 2, 64, 1, True, 200),
    # B*KV = 64 rows: 5 CTAs a row, two tiles a warp
    (8, 1024, 16, 8, 128, 0, False, 1100),
    # G = 5 and G = 8
    (2, 512, 10, 2, 64, 0, True, 700),
    (2, 512, 16, 2, 128, 0, False, 300),
    (1, 96, 8, 1, 256, 0, False, 95),
    (1, 64, 8, 1, 32, 17, True, 80),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos", K2_EDGE_CASES)
def test_decode_k2_edges(gen, dtype, B, S, H, KV, dh, window, ring, pos):
    dt = getattr(torch, dtype)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda", dtype=dt)
    q, ck, cv = r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh)
    before = dec.decode_attention.launches
    out = dec.decode_attention(q, ck, cv, pos, window=window, ring=ring)
    ref = dec.decode_attention_plain(q, ck, cv, pos, window=window,
                                     ring=ring)
    torch.cuda.synchronize()
    assert dec.decode_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    assert _err(out, ref) < _tol(dt)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 64, 4, 48, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fl.flash_attention(q, q[:, :, :2].contiguous(),
                           q[:, :, :2].contiguous())
    q = torch.randn(1, 64, 4, 64, generator=gen, device="cuda",
                    dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fl.flash_attention(q, q, q)
    q = torch.randn(1, 1, 4, 64, generator=gen, device="cuda")
    ck = torch.randn(1, 2, 32, 64, generator=gen,
                     device="cuda").transpose(1, 2)   # (1, 32, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        dec.decode_attention(q, ck, ck, 3)
    # a group of 9 query heads per kv head is computed, in sub-groups
    q = torch.randn(1, 1, 18, 64, generator=gen, device="cuda")
    ck = torch.randn(1, 32, 2, 64, generator=gen, device="cuda")
    assert _err(dec.decode_attention(q, ck, ck, 3),
                dec.decode_attention_plain(q, ck, ck, 3)) < _tol(q.dtype)
    buf = torch.randn(1 + 64 * 4 * 64, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    x = buf[1:].view(1, 64, 4, 64)   # contiguous, 2 bytes past alignment
    with pytest.raises(ValueError, match="aligned"):
        fl.flash_attention(x, x, x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KV,dh,ring,pos", [
    (32, 2, 128, False, 1039),   # chatglm3-6b decode: G 16
    (18, 2, 64, True, 300),      # G 9: three sub-groups of 3
    (24, 2, 32, False, 50),      # G 12: two sub-groups of 6
    (32, 1, 64, True, 2000),     # G 32: four sub-groups of 8
])
def test_decode_k2_groups_above_8(gen, dtype, H, KV, dh, ring, pos):
    """K2 takes at most 8 query heads per kv head a launch on
    decode_cluster (float32, dh 32 and 256), 16 on decode_sm90; the
    wrapper runs a larger group in sub-groups, one launch each, within one
    counted call, and never raises for a group that divides H."""
    dt = getattr(torch, dtype)
    B, S = 4, 1024
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda", dtype=dt)
    q, ck, cv = r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh)
    before = dec.decode_attention.launches
    out = dec.decode_attention(q, ck, cv, pos, ring=ring)
    ref = dec.decode_attention_plain(q, ck, cv, pos, ring=ring)
    torch.cuda.synchronize()
    assert dec.decode_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    assert _row_rel(out.float(), ref.float()) <= 2.0 ** -6


def _row_rel(out, ref) -> float:
    d = (out - ref).abs().amax(-1)
    return (d / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def _check_k3(gen, dtype, B, S, H, KV, dh, window, ring, pos, k=None,
              v=None):
    """K3 (one counted wrapper call) against its plain version and against
    the transcription of its arithmetic: bf16 rows within 2**-6 of each
    row's largest value, f32 within 2e-5. ``k``, ``v``: the float cache to
    quantize, random normal if not given."""
    dt = getattr(torch, dtype)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    q = r(B, 1, H, dh).to(dt)
    k8, ks = attn.quantize_kv(r(B, S, KV, dh) if k is None else k)
    v8, vs = attn.quantize_kv(r(B, S, KV, dh) if v is None else v)
    args = (q, k8, ks, v8, vs, pos)
    before = dec.decode_attention_quant.launches
    out = dec.decode_attention_quant(*args, window=window, ring=ring)
    torch.cuda.synchronize()
    assert dec.decode_attention_quant.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    assert torch.isfinite(out).all()
    for ref_fn in (dec.decode_attention_quant_plain,
                   dec.decode_attention_quant_as_kernel):
        ref = ref_fn(*args, window=window, ring=ring)
        if dt == torch.bfloat16:
            assert _row_rel(out.float(), ref.float()) <= 2.0 ** -6
        else:
            assert _err(out, ref) < 2e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos", K2_EDGE_CASES)
def test_decode_k3_edges(gen, dtype, B, S, H, KV, dh, window, ring, pos):
    """K3's cluster kernel at K2's edges (positions 0, 1 and 31, S not a
    tile multiple, a window-1 ring, B*KV = 64, G 5 and 8, dh 32 and 256)."""
    _check_k3(gen, dtype, B, S, H, KV, dh, window, ring, pos)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KV,dh,ring,pos", [
    (32, 2, 128, False, 1039),   # chatglm3-6b decode: G 16
    (18, 2, 64, True, 300),      # G 9: three sub-groups of 3
    (24, 2, 32, False, 50),      # G 12: two sub-groups of 6
    (32, 1, 64, True, 2000),     # G 32: four sub-groups of 8
])
def test_decode_k3_groups_above_8(gen, dtype, H, KV, dh, ring, pos):
    """K3 runs a group of more than 8 query heads per kv head as K2 does,
    in sub-groups of one launch each, within one wrapper call."""
    _check_k3(gen, dtype, 4, 1024, H, KV, dh, 0, ring, pos)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [64, 128])
def test_decode_k3_zero_and_mixed_rows(gen, dtype, dh):
    """Cache rows of all zeros (quantized with the clamped scale
    1e-8 / 127) among rows whose magnitudes span four decades (k) and six
    (v), so that the per-slot scales differ by as much; the largest k rows
    sit late in the cache, so the running max moves between tiles."""
    B, S, H, KV = 2, 300, 8, 2
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")

    def spread(lo, hi):
        m = 10.0 ** torch.linspace(lo, hi, S, device="cuda")
        return m[torch.randperm(S, generator=gen, device="cuda")]
    km = spread(-3.0, 1.0)
    km[-40:] = 10.0
    k = r(B, S, KV, dh) * km[None, :, None, None] / dh ** 0.5
    v = r(B, S, KV, dh) * spread(-6.0, 0.0)[None, :, None, None]
    for t in (k, v):
        t[:, ::7] = 0.0
        t[:, 3, 1] = 0.0
    _, ks = attn.quantize_kv(k)
    assert float(ks.min()) == pytest.approx(1e-8 / 127.0)
    _check_k3(gen, dtype, B, S, H, KV, dh, 0, False, S + 5, k, v)


def test_k3_wrapper_refuses_what_the_kernel_does_not_take(gen):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    q = r(1, 1, 4, 64)
    k8, ks = attn.quantize_kv(r(1, 32, 2, 64))
    with pytest.raises(ValueError, match="dtype"):
        dec.decode_attention_quant(q.half(), k8, ks, k8, ks, 3)
    with pytest.raises(ValueError, match="dtype"):
        dec.decode_attention_quant(q, k8.float(), ks, k8.float(), ks, 3)
    with pytest.raises(ValueError, match="scales must be float32"):
        dec.decode_attention_quant(q, k8, ks.half(), k8, ks.half(), 3)
    with pytest.raises(ValueError, match=r"scales must be \(B, S, KV\)"):
        dec.decode_attention_quant(q, k8, ks[:, :16], k8, ks[:, :16], 3)
    with pytest.raises(ValueError, match="head dim"):
        q48 = r(1, 1, 4, 48)
        k48, ks48 = attn.quantize_kv(r(1, 32, 2, 48))
        dec.decode_attention_quant(q48, k48, ks48, k48, ks48, 3)
    kt = k8.transpose(1, 2).contiguous().transpose(1, 2)   # (1, 32, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        dec.decode_attention_quant(q, kt, ks, kt, ks, 3)
    buf = torch.zeros(1 + 32 * 2 * 64, dtype=torch.int8, device="cuda")
    k_off = buf[1:].view(1, 32, 2, 64)   # contiguous, 1 byte past alignment
    with pytest.raises(ValueError, match="aligned"):
        dec.decode_attention_quant(q, k_off, ks, k_off, ks, 3)
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_attention_quant(q, k8.cpu(), ks, k8, ks, 3)


# whisper-large-v3 (20 heads of dh 64 over 20 kv heads, G 1): K1
# non-causal with Sq != Sk (the encoder's 1500 x 1500; the decoder
# prefill's cross-attention, 432 queries over 1500 frames, whose 1500 keys
# leave a 28-key tail block of 64); K2 and K3 over its 1500-frame cross
# cache (one query over every frame: pos 1499) and its 432-slot self
# cache after 16 decode steps, whose cluster_plan chunks (375 and 108
# slots on 132 SMs; K3's 215 and 62) are not multiples of the 32-slot
# tile, so a CTA's range ends mid-tile

def _check_rows(out, ref, dt):
    if dt == torch.bfloat16:
        assert _row_rel(out.float(), ref.float()) <= 2.0 ** -6
    else:
        assert _err(out, ref) < 2e-5


def _check_flash_cross(gen, dtype, B, Sq, Sk, H, KV, dh):
    dt = getattr(torch, dtype)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda", dtype=dt)
    q, k, v = r(B, Sq, H, dh), r(B, Sk, KV, dh), r(B, Sk, KV, dh)
    before = fl.flash_attention.launches
    out = fl.flash_attention(q, k, v, causal=False)
    ref = fl.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fl.flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    _check_rows(out, ref, dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk", [(4, 432, 1500), (4, 1500, 1500)])
def test_flash_kernel_at_whisper_shapes(gen, dtype, B, Sq, Sk):
    _check_flash_cross(gen, dtype, B, Sq, Sk, 20, 20, 64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_kernel_tail_key_block_by_batch_row(gen, dtype, dh):
    """1500 keys: at dh 128 11 blocks of 128 and a tail of 92, at dh 64
    13 blocks of 112 and a tail of 44, which TMA fills with zeros past
    each batch row's last key (zero keys, masked to -1e30, not scored 0),
    in three batch rows."""
    _check_flash_cross(gen, dtype, 3, 432, 1500, 4, 2, dh)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("Sq,Sk", [(1, 100), (7, 100), (40, 100),
                                   (150, 100), (1, 1500), (65, 1500),
                                   (63, 193), (129, 64), (128, 128),
                                   (193, 127), (192, 1500), (1500, 65)])
def test_flash_kernel_non_causal_cross(gen, dtype, dh, Sq, Sk):
    """Fewer queries than keys and more, key counts off the key block."""
    _check_flash_cross(gen, dtype, 2, Sq, Sk, 4, 2, dh)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,dh,pos", [
    (4, 1500, 20, 20, 64, 1499),   # whisper's cross cache
    (4, 432, 20, 20, 64, 447),     # its self cache, the query past its end
    (2, 300, 3, 3, 128, 299),      # 8 CTAs of 38 slots, the last of 34
])
def test_decode_kernels_at_whisper_caches(gen, dtype, B, S, H, KV, dh, pos):
    dt = getattr(torch, dtype)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda", dtype=dt)
    q, ck, cv = r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh)
    before = dec.decode_attention.launches
    out = dec.decode_attention(q, ck, cv, pos)
    ref = dec.decode_attention_plain(q, ck, cv, pos)
    torch.cuda.synchronize()
    assert dec.decode_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    _check_rows(out, ref, dt)
    _check_k3(gen, dtype, B, S, H, KV, dh, 0, False, pos)


def _scan_inputs(gen, B, S, H, dh):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return (r(B, S, H, dh) * dh ** -0.5, r(B, S, H, dh) * dh ** -0.5,
            r(B, S, H, dh), r(B, S, H), r(B, S, H) + 2.0)


@pytest.mark.parametrize("dh", [32, 128, 512])
@pytest.mark.parametrize("S", [1, 100, 1024])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_kernel_vs_plain(gen, dh, S, with_state):
    B, H = 2, 2
    state = None
    if with_state:
        # a state the recurrence reached: the final state of a first scan
        _, state = k4.mlstm_scan_plain(*_scan_inputs(gen, B, 64, H, dh))
    args = _scan_inputs(gen, B, S, H, dh)
    before = k4.mlstm_scan.launches
    h, (C, n, m) = k4.mlstm_scan(*args, state)
    rh, (rC, rn, rm) = k4.mlstm_scan_plain(*args, state)
    torch.cuda.synchronize()
    assert k4.mlstm_scan.launches == before + 1
    assert h.shape == args[0].shape and C.shape == (B, H, dh, dh)
    for name, a, b in [("h", h, rh), ("C", C, rC), ("n", n, rn),
                       ("m", m, rm)]:
        assert _row_rel(a, b) <= 1e-4, name


def test_mlstm_wrapper_refuses_what_the_kernel_does_not_take(gen):
    args = _scan_inputs(gen, 1, 8, 2, 64)
    with pytest.raises(ValueError, match="float32"):
        k4.mlstm_scan(*(a.bfloat16() for a in args))
    q = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k4.mlstm_scan(q, *args[1:])
    with pytest.raises(ValueError, match="one CUDA device"):
        k4.mlstm_scan(args[0], args[1].cpu(), *args[2:])
    _, state = k4.mlstm_scan_plain(*args)
    with pytest.raises(ValueError, match="one CUDA device"):
        k4.mlstm_scan(*args, tuple(t.cpu() for t in state))
    with pytest.raises(ValueError, match="head dim"):
        k4.mlstm_scan(*_scan_inputs(gen, 1, 8, 2, 48))


def _ssm_inputs(gen, B, S, Hs, P, N, dtype, w_dtype):
    """As ``tests/test_kernels.py::TestSsmScan``: normal x, b, c, d_skip,
    dt = softplus(normal), a_log = 0.3 * normal (per-head A and D, so a
    head-indexing fault shows)."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return (r(B, S, Hs, P).to(dtype), torch.nn.functional.softplus(
        r(B, S, Hs)), (r(Hs) * 0.3).to(w_dtype), r(B, S, N), r(B, S, N),
        r(Hs).to(w_dtype))


def _check_ssm(gen, B, S, Hs, P, N, dtype, w_dtype, with_state):
    state = None
    if with_state:
        # a state the recurrence reached: the final state of a first scan
        _, state = k5.ssm_scan_plain(*_ssm_inputs(gen, B, 64, Hs, P, N,
                                                  dtype, w_dtype))
    args = _ssm_inputs(gen, B, S, Hs, P, N, dtype, w_dtype)
    before = k5.ssm_scan.launches
    y, fin = k5.ssm_scan(*args, state)
    ry, rfin = k5.ssm_scan_plain(*args, state)
    torch.cuda.synchronize()
    assert k5.ssm_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    assert fin.dtype == torch.float32 and fin.shape == (B, Hs, P, N)
    y_tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    assert _row_rel(y.float(), ry.float()) <= y_tol
    assert _row_rel(fin, rfin) <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,N", [(16, 8), (16, 16), (32, 8), (32, 16),
                                 (64, 8), (64, 16)])
@pytest.mark.parametrize("S", [1, 100, 1024])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_kernel_vs_plain(gen, dtype, P, N, S, with_state):
    dt = getattr(torch, dtype)
    _check_ssm(gen, 2, S, 3, P, N, dt, dt, with_state)


@pytest.mark.parametrize("dtype,w_dtype", [("float32", "bfloat16"),
                                           ("bfloat16", "float32")])
def test_ssm_kernel_mixed_weight_dtype(gen, dtype, w_dtype):
    _check_ssm(gen, 1, 77, 5, 48, 16, getattr(torch, dtype),
               getattr(torch, w_dtype), True)


def test_ssm_kernel_at_hymba_serving_shape(gen):
    """hymba-1.5b's prefill (B 4, S 1024, 25 heads of P 64, N 16), bf16."""
    _check_ssm(gen, 4, 1024, 25, 64, 16, torch.bfloat16, torch.bfloat16,
               True)


def test_ssm_wrapper_refuses_what_the_kernel_does_not_take(gen):
    f32 = torch.float32
    args = _ssm_inputs(gen, 1, 8, 2, 32, 16, f32, f32)
    with pytest.raises(ValueError, match="one CUDA device"):
        k5.ssm_scan(args[0], args[1].cpu(), *args[2:])
    _, state = k5.ssm_scan_plain(*args)
    with pytest.raises(ValueError, match="one CUDA device"):
        k5.ssm_scan(*args, state.cpu())
    with pytest.raises(ValueError, match="state size"):
        k5.ssm_scan(*_ssm_inputs(gen, 1, 8, 2, 32, 12, f32, f32))
    with pytest.raises(ValueError, match="head dim"):
        k5.ssm_scan(*_ssm_inputs(gen, 1, 8, 2, 24, 16, f32, f32))
    with pytest.raises(ValueError, match="dtypes"):
        k5.ssm_scan(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="dtypes"):
        k5.ssm_scan(args[0], args[1].bfloat16(), *args[2:])
    x = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k5.ssm_scan(x, *args[1:])


def _mlstm_state(gen, kind, B, H, dh):
    if kind == "omitted":
        return None
    if kind == "zero":
        return (torch.zeros(B, H, dh, dh, device="cuda"),
                torch.zeros(B, H, dh, device="cuda"),
                torch.zeros(B, H, device="cuda"))
    # a state the recurrence reached: the final state of a first scan
    return k4.mlstm_scan_plain(*_scan_inputs(gen, B, 64, H, dh))[1]


@pytest.mark.parametrize("dh", [64, 512])
@pytest.mark.parametrize("state", ["omitted", "zero", "random"])
@pytest.mark.parametrize("S", [k4.CHUNK - 1, k4.CHUNK, k4.CHUNK + 1,
                               3 * k4.CHUNK + 5])
def test_mlstm_kernel_chunk_edges(gen, dh, state, S):
    """K4 around its chunk length (the step path below it, the chunkwise
    path from it up) from the omitted, the model's zero and a reached
    state."""
    B, H = 2, 2
    st = _mlstm_state(gen, state, B, H, dh)
    args = _scan_inputs(gen, B, S, H, dh)
    h, fin = k4.mlstm_scan(*args, st)
    rh, rfin = k4.mlstm_scan_plain(*args, st)
    torch.cuda.synchronize()
    for name, a, b in zip("hCnm", (h,) + fin, (rh,) + rfin):
        assert _row_rel(a, b) <= 1e-4, name


def _tensor_rel(out, ref) -> float:
    """max |out - ref| over max |ref| of the whole tensor."""
    return ((out - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("gates", ["forget_closed", "input_open"])
def test_mlstm_kernel_gates_at_the_edges(gen, gates):
    """Forget gates shut (fg - 30) and input gates wide open (ig + 30):
    the chunk's decays underflow, and m follows ig. The state keeps the
    row-relative measure; h is held relative to its largest value: with
    the forget gates shut a row of h is v_t (q_t . k_t), and in the rows
    where q_t . k_t is near 0 two f32 sums in different orders differ
    by about 2^-24 sum_j |q_j k_j|, far more than 1e-4 of the row (the
    step kernel and the plain version differ there too)."""
    B, S, H, dh = 2, 3 * k4.CHUNK + 5, 2, 128
    q, k, v, ig, fg = _scan_inputs(gen, B, S, H, dh)
    if gates == "forget_closed":
        fg = fg - 30.0
    else:
        ig = ig + 30.0
    st = _mlstm_state(gen, "random", B, H, dh)
    h, fin = k4.mlstm_scan(q, k, v, ig, fg, st)
    rh, rfin = k4.mlstm_scan_plain(q, k, v, ig, fg, st)
    torch.cuda.synchronize()
    assert _tensor_rel(h, rh) <= 1e-4
    for name, a, b in zip("Cnm", fin, rfin):
        assert _row_rel(a, b) <= 1e-4, name


def _device_kernels(fn):
    """The names of the CUDA kernels ``fn()`` runs on the device, one
    entry a launch, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _device_launches(source, fn):
    """The device launches ``fn()`` makes through ``csrc/<source>.cu``, by
    kernel code (the wrapper's ``KERNELS``), from the library's own counts:
    exact, where torch.profiler's trace has come back empty in long runs
    on the card."""
    import ctypes
    from repro_torch.kernels import _build
    count = getattr(_build.library(source), f"{source}_device_launches")
    count.restype, count.argtypes = ctypes.c_longlong, [ctypes.c_int]
    codes = range({"mlstm_scan": len(k4.KERNELS),
                   "ssm_scan": len(k5.KERNELS),
                   "decode_attention": len(dec.KERNELS)}[source])
    before = [count(k) for k in codes]
    out = fn()
    torch.cuda.synchronize()
    return [count(k) - b for k, b in zip(codes, before)], out


K4_KERNELS = {"steps": ["mlstm_scan_kernel"], "sm90": ["mlstm_cluster"],
              "mma_sync": ["mlstm_chunk_prep", "mlstm_chunk_state"]}
K5_KERNELS = {"steps": ["ssm_scan_kernel"], "sm90": ["ssd_cluster"]}


def test_mlstm_dispatch_at_the_chunk_length(gen):
    """Below ``CHUNK`` steps the step kernel runs, from it up the Hopper
    kernel (dh 128 up) or the two mma.sync chunkwise kernels (dh 64), as
    ``kernel_for`` says; the library's chunk is the wrapper's."""
    from repro_torch.kernels import _build
    assert _build.library("mlstm_scan").mlstm_scan_chunk() == k4.CHUNK
    for dh in (64, 512):
        for S in (1, k4.CHUNK - 1, k4.CHUNK):
            args = _scan_inputs(gen, 1, S, 2, dh)
            names = _device_kernels(lambda: k4.mlstm_scan(*args))
            want = K4_KERNELS[k4.kernel_for(S, dh)]
            assert len(names) == len(want), names
            assert all(w in n for w, n in zip(want, names)), names
            assert k4.uses_chunks(S) == (S >= k4.CHUNK)


@pytest.mark.parametrize("dh", [128, 256, 512])
@pytest.mark.parametrize("S", [k4.CHUNK, k4.CHUNK + 1, 3 * k4.CHUNK + 5,
                               1024])
def test_mlstm_prefill_is_one_launch(gen, dh, S):
    """A prefill call (S >= CHUNK) at dh 128 up is one device launch, the
    Hopper kernel's cluster launch (counted by the library; the dispatch
    test above reads the same off torch.profiler), and its outputs hold
    to the plain version; xlstm-350m's dh 512 among them."""
    B, H = 2, 2
    st = _mlstm_state(gen, "random", B, H, dh)
    args = _scan_inputs(gen, B, S, H, dh)
    assert k4.kernel_for(S, dh) == "sm90"
    made, (h, fin) = _device_launches(
        "mlstm_scan", lambda: k4.mlstm_scan(*args, st))
    assert made == [0, 0, 1], made
    rh, rfin = k4.mlstm_scan_plain(*args, st)
    for name, a, b in zip("hCnm", (h,) + fin, (rh,) + rfin):
        assert _row_rel(a, b) <= 1e-4, name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("S", [k5.CHUNK - 1, k5.CHUNK, k5.CHUNK + 1,
                               3 * k5.CHUNK + 5])
def test_ssm_kernel_chunk_edges(gen, dtype, state, S):
    """K5 around its chunk length (the step path below it, the chunked
    path from it up), with every head of the CTAs' head groups (Hs 7) and
    P 48, from the omitted and a reached state."""
    dt = getattr(torch, dtype)
    _check_ssm(gen, 2, S, 7, 48, 16, dt, dt, state)


def test_ssm_kernel_decay_underflow(gen):
    """dt scaled by 200 (x by 1 / 200): exp(dt A) and the chunk's
    cumulated decays underflow to 0, and the masked exponents stay
    masked. The state keeps the row-relative measure; y is held relative
    to its largest value: with the history decayed away a row of y is
    x_t (dt_t C_t . B_t + D), ill-conditioned where the two terms
    cancel."""
    f32 = torch.float32
    x, dt, a_log, b, c, d_skip = _ssm_inputs(gen, 2, 101, 3, 64, 16, f32,
                                             f32)
    dt, x = dt * 200.0, x / 200.0
    _, state = k5.ssm_scan_plain(*_ssm_inputs(gen, 2, 64, 3, 64, 16, f32,
                                              f32))
    y, fin = k5.ssm_scan(x, dt, a_log, b, c, d_skip, state)
    ry, rfin = k5.ssm_scan_plain(x, dt, a_log, b, c, d_skip, state)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    assert _tensor_rel(y, ry) <= 1e-4 and _row_rel(fin, rfin) <= 1e-4


def test_ssm_dispatch_at_the_chunk_length(gen):
    """Below ``CHUNK`` steps the step kernel runs, from it up the Hopper
    kernel, as ``kernel_for`` says; the library's chunk is the
    wrapper's."""
    from repro_torch.kernels import _build
    assert _build.library("ssm_scan").ssm_scan_chunk() == k5.CHUNK
    f32 = torch.float32
    for S in (1, k5.CHUNK - 1, k5.CHUNK):
        args = _ssm_inputs(gen, 1, S, 2, 32, 16, f32, f32)
        names = _device_kernels(lambda: k5.ssm_scan(*args))
        want = K5_KERNELS[k5.kernel_for(S, f32, 32, 16)]
        assert len(names) == len(want), names
        assert all(w in n for w, n in zip(want, names)), names
        assert k5.uses_chunks(S) == (S >= k5.CHUNK)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [k5.CHUNK, k5.CHUNK + 1, 3 * k5.CHUNK + 5,
                               1024])
def test_ssm_prefill_is_one_launch(gen, dtype, S):
    """A prefill call (S >= CHUNK) is one device launch, the Hopper
    kernel's cluster launch (no scratch, no state pass; counted by the
    library, as torch.profiler reads it in the dispatch test above), at
    hymba-1.5b's head shape (P 64, N 16), and its outputs hold to the
    plain version."""
    dt = getattr(torch, dtype)
    args = _ssm_inputs(gen, 2, S, 3, 64, 16, dt, dt)
    _, state = k5.ssm_scan_plain(*_ssm_inputs(gen, 2, 64, 3, 64, 16, dt,
                                              dt))
    assert k5.kernel_for(S, dt, 64, 16) == "sm90"
    made, (y, fin) = _device_launches(
        "ssm_scan", lambda: k5.ssm_scan(*args, state))
    assert made == [0, 1], made
    ry, rfin = k5.ssm_scan_plain(*args, state)
    tol = 2.0 ** -6 if dt == torch.bfloat16 else 1e-4
    assert _row_rel(y, ry) <= tol and _row_rel(fin, rfin) <= 1e-4


def _moe_layer(gen, cfg):
    """One MoE layer of ``cfg`` with random weights on the card (the
    router float32, the experts in the compute dtype)."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.compute_dtype
    return {"router": r(d, E) * d ** -0.5,
            "we1": (r(E, d, f) * d ** -0.5).to(dt),
            "we3": (r(E, d, f) * d ** -0.5).to(dt),
            "we2": (r(E, f, d) * f ** -0.5).to(dt)}


def test_moe_apply_is_deterministic_on_the_card(gen):
    """Full-width granite-moe-3b-a800m, one layer, at its prefill (B 4,
    S 1024: 32768 pairs, capacity 1025 an expert) and decode (B 4, one
    token: dropless) in bf16: two runs give the same bits (the combine
    adds each token's contributions in a fixed order, not by atomics), and
    the bf16 output is within 2e-2 of its largest value of the float32
    experts' on the same routing."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-3b-a800m")
    p = _moe_layer(gen, cfg)
    p32 = {k: v.float() for k, v in p.items()}
    assert moe.capacity(cfg, 4096) == 1025
    for S in (1024, 1):
        x = torch.randn(4, S, cfg.d_model, generator=gen,
                        device="cuda").to(torch.bfloat16)
        y1, a1 = moe.moe_apply(cfg, p, x)
        y2, a2 = moe.moe_apply(cfg, p, x)
        torch.cuda.synchronize()
        assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
        assert float(a1) == float(a2)
        y32, _ = moe.moe_apply(cfg, p32, x.float())
        assert _err(y1, y32) <= 2e-2 * float(y32.abs().max())


def test_moe_apply_on_the_card_matches_the_cpu(gen):
    """float32, granite's widths cut to 4 experts of top 2 at T 2080 (4160
    pairs: capacity 1300), a router tilted to expert 0 so that it
    overflows: the card's sort, dispatch, drops and combine give the
    CPU's y within 2e-5 of its largest value."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              d_model=1536, d_ff=512)
    p = _moe_layer(gen, cfg)
    p["router"][:, 0] += 0.05
    x = torch.randn(2, 1040, cfg.d_model, generator=gen, device="cuda") + 1
    top = torch.topk(x.reshape(-1, cfg.d_model) @ p["router"], 2).indices
    assert int(torch.bincount(top.reshape(-1)).max()) > \
        moe.capacity(cfg, 2080) == 1300
    y, aux = moe.moe_apply(cfg, p, x)
    yc, auxc = moe.moe_apply(cfg, {k: v.cpu() for k, v in p.items()},
                             x.cpu())
    assert _err(y.cpu(), yc) <= 2e-5 * float(yc.abs().max())
    assert abs(float(aux) - float(auxc)) < 1e-5


# --- training: no kernel, plain versions under autograd ----------------------

def _refusing_calls():
    """Each wrapper's call on small CUDA inputs, taking the tensor that
    will require grad."""
    r = lambda *s: torch.randn(*s, device="cuda")
    kv = r(1, 64, 1, 64)
    c8 = torch.zeros(1, 64, 1, 64, dtype=torch.int8, device="cuda")
    sc, g = torch.ones(1, 64, 1, device="cuda"), r(1, 64, 2)
    x, bc = r(1, 64, 2, 16), r(1, 64, 8)
    return {
        "flash_attention": (fl.flash_attention,
                            lambda t: fl.flash_attention(t, kv, kv),
                            r(1, 64, 2, 64)),
        "decode_attention": (dec.decode_attention,
                             lambda t: dec.decode_attention(t, kv, kv, 3),
                             r(1, 1, 2, 64)),
        "decode_attention_quant": (
            dec.decode_attention_quant,
            lambda t: dec.decode_attention_quant(t, c8, sc, c8, sc, 3),
            r(1, 1, 2, 64)),
        "mlstm_scan": (k4.mlstm_scan, lambda t: k4.mlstm_scan(t, t, t, g, g),
                       r(1, 64, 2, 64)),
        "ssm_scan": (k5.ssm_scan,
                     lambda t: k5.ssm_scan(x, g.abs(), torch.zeros(
                         2, device="cuda"), bc, bc, torch.ones(
                         2, device="cuda"), t),
                     torch.zeros(1, 2, 16, 8, device="cuda"))}


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "decode_attention_quant", "mlstm_scan",
                                  "ssm_scan"])
def test_wrappers_refuse_autograd_on_the_card(gen, name):
    """A CUDA input that requires grad under grad mode raises before any
    launch: the kernel's output would carry no graph."""
    wrapper, call, t = _refusing_calls()[name]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="requires grad"):
        call(t.clone().requires_grad_())
    assert wrapper.launches == before
    with torch.no_grad():
        call(t.clone().requires_grad_())
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_loss_and_grads_on_the_card_match_the_cpu(gen, arch):
    """Reduced float32 models (random weights drawn on the CPU): the
    card's loss within 1e-5 relative of the CPU's and every grad leaf
    within 1e-4 of the leaf's largest |g| (the MoE backward's gathers
    add by float atomics on the card); no kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training.trainer import trainable
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    host = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    counts = [w.launches for w in (fl.flash_attention, dec.decode_attention,
                                   k4.mlstm_scan, k5.ssm_scan)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = trainable(tree_map(lambda t: t.to(dev), host))
        t = toks.to(dev)
        loss, _ = model.loss_fn(params, {"tokens": t, "labels": t})
        grads = torch.autograd.grad(loss, list(tree_leaves(params)))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gc, gg):
        assert _err(a, b) <= 1e-4 * float(a.abs().max())
    assert counts == [w.launches for w in (
        fl.flash_attention, dec.decode_attention, k4.mlstm_scan,
        k5.ssm_scan)]


def test_checkpoint_round_trip_on_the_card(gen, tmp_path):
    """bf16 parameters and float32 moments saved from the card come back
    onto the card with the same bits."""
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    params = {"w": torch.randn(33, 7, generator=gen, device="cuda")
              .to(torch.bfloat16),
              "b": {"c": torch.randn(5, generator=gen, device="cuda")}}
    state = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    state["opt"].m["w"].normal_(generator=gen)
    path = str(tmp_path / "c.npz")
    ckpt.save(path, state, step=4)
    back, step = ckpt.restore(path, state)
    assert step == 4
    for (k, a), (_, b) in zip(ckpt.keyed_leaves(state),
                              ckpt.keyed_leaves(back)):
        assert b.is_cuda and a.dtype == b.dtype, k
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), k


def test_batchsim_lanes_on_the_card_match_the_cpu(gen):
    """The batch simulator's lanes (sticky, plain MQFQ's splitmix draws,
    FCFS, SJF, under memory pressure) on the card give the CPU's run bit
    for bit."""
    from repro_torch.batchsim import FAM_FCFS, FAM_MQFQ, FAM_SJF, make_params
    from repro_torch.batchsim.sweep import run_batch
    from repro_torch.workloads.traces import padded_arrivals
    pa = padded_arrivals("zipf", n_fns=8, duration=120.0, total_rps=1.0,
                         seed=3)
    F = len(pa.fn_ids)
    pts = [make_params(F, family=fam, sticky=sticky, d=d, pool_size=3,
                       capacity_bytes=2.5 * 2**30, h2d_bw=8 * 2**30, seed=5)
           for fam, sticky, d in ((FAM_MQFQ, True, 2), (FAM_MQFQ, False, 3),
                                  (FAM_FCFS, True, 2), (FAM_SJF, True, 1))]
    card = run_batch(pa, pts, device="cuda")
    cpu = run_batch(pa, pts, device="cpu")
    assert card["device"].startswith("cuda")
    for k in cpu["raw"]:
        assert card["raw"][k].tobytes() == cpu["raw"][k].tobytes(), k
    assert card["summary"] == cpu["summary"]


# K2 and K3 on decode_sm90 (bf16 at dh 64 and 128): every served decode
# shape of chip_smoke.py's kernel phase (qwen3-1.7b, hymba-1.5b's ring,
# chatglm3-6b's G 16, granite, llava's 4096-slot ring, deepseek-coder-33b,
# qwen1.5-32b, whisper-large-v3's cross and self caches) and K2's edges at
# those head dims
SM90_SERVED = [
    (4, 1024, 16, 8, 128, 0, False, 1039),
    (4, 1024, 25, 5, 64, 1024, True, 1039),
    (4, 1024, 32, 2, 128, 0, False, 1039),
    (4, 1024, 24, 8, 64, 0, False, 1039),
    (4, 4096, 32, 8, 128, 4096, True, 4111),
    (4, 1024, 56, 8, 128, 0, False, 1039),
    (4, 1024, 40, 40, 128, 0, False, 1039),
    (4, 1500, 20, 20, 64, 0, False, 1499),
    (4, 432, 20, 20, 64, 0, False, 447),
]
SM90_EDGES = [c for c in K2_EDGE_CASES if c[4] in (64, 128)]
# qwen1.5-32b's 40 kv heads at B 8 and 16: 320 rows fill about one wave of
# one-CTA clusters with the deepest ring, 640 take several waves
SM90_MANY_ROWS = [(8, 1024, 40, 40, 128, 0, False, 1039),
                  (16, 1024, 40, 40, 128, 0, False, 1039)]


@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos",
                         SM90_SERVED + SM90_EDGES + SM90_MANY_ROWS)
def test_sm90_decode_vs_plain(gen, B, S, H, KV, dh, window, ring, pos):
    """One wrapper call of K2 and of K3 is one device launch of
    decode_sm90 (G up to 16), each within 2**-6 of every row's largest
    value of its plain version; K3 also of the transcription of its
    arithmetic and of the kernel's split and merge order under its plan."""
    assert dec.kernel_for(torch.bfloat16, dh) == "sm90"
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
    q, ck, cv = r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh)
    kw = dict(window=window, ring=ring)
    made, out = _device_launches(
        "decode_attention", lambda: dec.decode_attention(q, ck, cv, pos, **kw))
    assert made == [0, 1], made
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert _row_rel(out.float(), dec.decode_attention_plain(
        q, ck, cv, pos, **kw).float()) <= 2.0 ** -6
    k8, ks = attn.quantize_kv(ck)
    v8, vs = attn.quantize_kv(cv)
    made, out = _device_launches(
        "decode_attention",
        lambda: dec.decode_attention_quant(q, k8, ks, v8, vs, pos, **kw))
    assert made == [0, 1], made
    plan = dec.launch_plan(q.dtype, k8.dtype, B, S, H, KV, dh, q.device)
    for ref in (dec.decode_attention_quant_plain(q, k8, ks, v8, vs, pos,
                                                 **kw),
                dec.decode_attention_quant_as_kernel(q, k8, ks, v8, vs, pos,
                                                     **kw),
                dec.decode_sm90_plain(q, k8, v8, pos, n_ctas=plan["n_ctas"],
                                      chunk=plan["chunk"],
                                      stages=plan["stages"], k_scale=ks,
                                      v_scale=vs, **kw)):
        assert _row_rel(out.float(), ref.float()) <= 2.0 ** -6


def _sm90_direct(q, caches, pos, n_ctas, chunk, stages, window, ring):
    """One launch of decode_sm90 through the C entry under a plan of the
    caller's (K2: caches k, v; K3: k, k_scale, v, v_scale)."""
    from repro_torch.kernels import _build
    name = ("decode_attention_group_fwd" if len(caches) == 2
            else "decode_attention_q8_fwd")
    B, _, H, dh = q.shape
    S, KV = caches[0].shape[1], caches[0].shape[2]
    o = torch.empty_like(q)
    fn = _build.entry("decode_attention", name, len(caches) + 2, 15)
    err = fn(q.data_ptr(), *[t.data_ptr() for t in caches], o.data_ptr(),
             dec.KERNELS["sm90"], _build.DTYPES[q.dtype], B, S, H, KV,
             H // KV, 0, dh, pos, window, int(ring), n_ctas, chunk, stages,
             dh ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return o


# (dh, int8 cache, ring depth): rings shallower than a CTA's tiles at
# depths that are not multiples of the 4 consumer warps (stage s belongs
# to warp s % 4: 1-3 stages leave warps idle), and the deepest
SM90_DEPTHS = ([(128, False, st) for st in (1, 2, 3, 4)]
               + [(64, False, st) for st in (1, 3, 5, 6, 7, 8)]
               + [(128, True, st) for st in (1, 2, 3, 5, 6, 7, 8)]
               + [(64, True, st) for st in (1, 3, 6, 10, 13, 16)])


@pytest.mark.parametrize("dh,q8,stages", SM90_DEPTHS)
def test_sm90_decode_at_every_ring_depth(gen, dh, q8, stages):
    """decode_sm90 with one CTA a row over 32 tiles and with clusters of 2
    (16 tiles a CTA), under a window that skips tiles, at ring depths the
    plan takes only on a small card: within 2**-6 of every row's largest
    value of the plain version, and K3 of the transcription of its split
    and merge order at the same depth."""
    B, S, H, KV, pos, window = 2, 1024, 32, 2, 1500, 900
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
    q, ck, cv = r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh)
    kw = dict(window=window, ring=True)
    if q8:
        k8, ks = attn.quantize_kv(ck)
        v8, vs = attn.quantize_kv(cv)
        caches = (k8, ks, v8, vs)
        refs = [dec.decode_attention_quant_plain(q, *caches, pos, **kw)]
    else:
        caches = (ck, cv)
        refs = [dec.decode_attention_plain(q, ck, cv, pos, **kw)]
    for n_ctas in (1, 2):
        chunk = S // n_ctas
        out = _sm90_direct(q, caches, pos, n_ctas, chunk, stages, window,
                           True)
        assert torch.isfinite(out).all()
        want = list(refs)
        if q8:
            want.append(dec.decode_sm90_plain(
                q, k8, v8, pos, n_ctas=n_ctas, chunk=chunk, stages=stages,
                k_scale=ks, v_scale=vs, **kw))
        for ref in want:
            assert _row_rel(out.float(), ref.float()) <= 2.0 ** -6


@pytest.mark.parametrize("dtype,dh", [("float32", 64), ("float32", 128),
                                      ("bfloat16", 32), ("bfloat16", 256)])
def test_decode_cluster_runs_float32_and_dh_32_256(gen, dtype, dh):
    """float32 q and bf16 at dh 32 and 256 stay on decode_cluster: one
    device launch of it a call (G 5), none of decode_sm90."""
    dt = getattr(torch, dtype)
    assert dec.kernel_for(dt, dh) == "cluster"
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda", dtype=dt)
    q, ck, cv = r(2, 1, 10, dh), r(2, 300, 2, dh), r(2, 300, 2, dh)
    made, out = _device_launches(
        "decode_attention", lambda: dec.decode_attention(q, ck, cv, 310))
    assert made == [1, 0], made
    _check_rows(out, dec.decode_attention_plain(q, ck, cv, 310), dt)
    k8, ks = attn.quantize_kv(ck.float())
    made, _ = _device_launches(
        "decode_attention",
        lambda: dec.decode_attention_quant(q, k8, ks, k8, ks, 310))
    assert made == [1, 0], made


def test_sm90_smem_and_fit_on_the_card(gen):
    """The C layout's shared memory is the plan's mirror of it, at every
    kernel and a spread of groups, clusters and rings; the card holds the
    plan's clusters at every served shape in one wave
    (cudaOccupancyMaxActiveClusters)."""
    import ctypes
    from repro_torch.kernels import _build
    smem = _build.library("decode_attention").decode_attention_sm90_smem
    smem.restype, smem.argtypes = ctypes.c_longlong, [ctypes.c_int] * 5
    for q8 in (0, 1):
        for dh in (64, 128):
            for G in (1, 2, 5, 8, 9, 16):
                for n in (1, 3, 8, 16):
                    for st in (1, 2, 4):
                        assert smem(q8, dh, G, n, st) == dec.sm90_smem(
                            G, dh, 1 if q8 else 2, n, st)
    for B, S, H, KV, dh, *_ in SM90_SERVED:
        for kv_dtype in (torch.bfloat16, torch.int8):
            plan = dec.launch_plan(torch.bfloat16, kv_dtype, B, S, H, KV, dh,
                                   "cuda:0")
            fits = dec._card_clusters(0, int(kv_dtype == torch.int8), dh,
                                      H // KV, plan["n_ctas"],
                                      plan["stages"])
            assert B * KV <= fits, (B, S, H, KV, dh, plan, fits)
