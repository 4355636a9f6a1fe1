"""K1: flash attention for prefill, in model layout.

q (B, Sq, H, dh), k/v (B, Sk, KV, dh) with GQA (H = KV * G); query i sits
at position i and key j at position j, as in the reference's wrapper
(``repro.kernels.flash_attention.ops.flash_attention``). On a CUDA tensor
``flash_attention`` launches a kernel of ``csrc/flash_attention.cu``,
the one ``kernel_for`` names (bfloat16 on the tensor cores, float32 on
the CUDA cores); on a CPU tensor it runs ``flash_attention_plain``.
"""
from __future__ import annotations


import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import masked_attention



def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """The kernel's function in plain PyTorch: masked attention with
    positions 0..Sq-1 and 0..Sk-1."""
    Sq, Sk = q.shape[1], k.shape[1]
    return masked_attention(q, k, v, torch.arange(Sq, device=q.device),
                            torch.arange(Sk, device=q.device),
                            causal=causal, window=window)


# K1's kernels, by the code the C entry takes
KERNELS = {"simt": 0, "mma_sync": 1, "sm90": 2}


def kernel_for(dtype, dh: int) -> str:
    """The kernel that runs K1 for inputs of ``dtype`` at head dim ``dh``:
    ``"sm90"`` (wgmma fed by TMA, bf16 at dh 64 and 128, the head dims of
    every served arch with attention), ``"mma_sync"`` (bf16 at dh 32 and
    256) or ``"simt"`` (float32 on the CUDA cores, every dh). A fixed
    choice: the C entry runs exactly this kernel or fails."""
    if dh not in _build.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{_build.HEAD_DIMS}")
    if dtype == torch.float32:
        return "simt"
    if dtype == torch.bfloat16:
        return "sm90" if dh in (64, 128) else "mma_sync"
    raise ValueError(f"flash_attention: dtype {dtype}; the kernels take "
                     f"float32 or bfloat16")


def _check(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         "device")
    if q.dtype not in _build.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes float32 or "
                         f"bfloat16, all alike")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B, Sq, H, dh) and k, v "
                         "(B, Sk, KV, dh) expected")
    B, Sq, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or H % k.shape[2]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)} do not match")
    if dh not in _build.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{_build.HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 inputs must be 16-byte "
                         "aligned")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Prefill attention: K1 on a CUDA tensor, the plain version on a CPU
    tensor; raises if autograd would record an input."""
    _build.refuse_dtensor("flash_attention", q, k, v)
    _build.refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    fn = _build.entry("flash_attention", "flash_attention_fwd", 4, 9)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             KERNELS[kernel_for(q.dtype, dh)], B, Sq, Sk, H, KV, dh,
             int(causal), int(window), dh ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    _build.count_launch(flash_attention)
    return o


flash_attention.launches = 0
