"""The port's CUDA kernels K1-K3 against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where no CUDA card
is present. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 for float32 (summation order only), 2e-2 for bfloat16.
This file imports no JAX, so it runs where JAX is absent.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.decode_attention import ops as dec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,dh", [
    (2, 256, 4, 2, 64), (1, 128, 4, 4, 32), (2, 192, 8, 2, 128),
    (1, 96, 3, 1, 64), (1, 64, 2, 2, 256), (1, 200, 2, 2, 64),
    (2, 1024, 16, 8, 128),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_flash_kernel_vs_plain(gen, dtype, B, S, H, KV, dh, causal, window):
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
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,dh,window,ring,pos", DECODE_CASES)
def test_decode_kernels_vs_plain(gen, dtype, B, S, H, KV, dh, window, ring,
                                 pos):
    dt = getattr(torch, dtype)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda", dtype=dt)
    q, ck, cv = r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh)
    out = dec.decode_attention(q, ck, cv, pos, window=window, ring=ring)
    ref = dec.decode_attention_plain(q, ck, cv, pos, window=window,
                                     ring=ring)
    torch.cuda.synchronize()
    assert out.dtype == dt and _err(out, ref) < _tol(dt)
    k8, ks = attn.quantize_kv(ck)
    v8, vs = attn.quantize_kv(cv)
    out = dec.decode_attention_quant(q, k8, ks, v8, vs, pos, window=window,
                                     ring=ring)
    ref = dec.decode_attention_quant_plain(q, k8, ks, v8, vs, pos,
                                           window=window, ring=ring)
    torch.cuda.synchronize()
    assert out.dtype == dt and _err(out, ref) < _tol(dt)


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
