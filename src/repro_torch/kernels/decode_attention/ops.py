"""K2 and K3: single-token decode attention against a KV cache, in model
layout.

q (B, 1, H, dh); cache k/v (B, S, KV, dh), bf16/f32 (K2) or int8 with
f32 scales (B, S, KV) (K3). Slot validity follows the reference
(``repro.kernels.decode_attention``): slot i holds the position that
``models.attention.full_slot_positions(pos, S)`` (or, for a ring,
``ring_slot_positions(pos + 1, S)``) gives it, and is valid iff that is
in [0, pos] and, with a window, above ``pos - window``; the kernels work
the positions out themselves. On a CUDA tensor the wrappers launch the
kernels of ``csrc/decode_attention.cu``; on a CPU tensor they run the
plain versions.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import (decode_attention as
                                          _model_decode_attention,
                                          dequantize_kv)

_MIN_CHUNK = 32          # cache slots per CTA, at least
_CTAS_PER_SM = 4         # split-K target: this many CTAs per SM


def decode_attention_plain(q, cache_k, cache_v, pos, *, window: int = 0,
                           ring: bool = False):
    """K2's function in plain PyTorch (``models.attention
    .decode_attention``): f32 scores, p cast to the cache type for p @ V."""
    return _model_decode_attention(q, cache_k, cache_v, pos, window=window,
                                   ring=ring)


def decode_attention_quant_plain(q, cache_k, k_scale, cache_v, v_scale, pos,
                                 *, window: int = 0, ring: bool = False):
    """K3's function in plain PyTorch: the int8 cache dequantized in f32,
    q upcast to f32, attention in f32, the output cast to q's type."""
    kf = dequantize_kv(cache_k, k_scale, torch.float32)
    vf = dequantize_kv(cache_v, v_scale, torch.float32)
    out = _model_decode_attention(q.float(), kf, vf, pos, window=window,
                                  ring=ring)
    return out.to(q.dtype)


def _check(q, cache_k, cache_v, kv_dtype, scales=()) -> None:
    tensors = (q, cache_k, cache_v) + tuple(scales)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("decode_attention: inputs must be on one CUDA "
                         "device")
    if q.dtype not in _build.DTYPES:
        raise ValueError(f"decode_attention: q dtype {q.dtype}; the kernel "
                         f"takes float32 or bfloat16")
    want_kv = q.dtype if kv_dtype is None else kv_dtype
    if cache_k.dtype != want_kv or cache_v.dtype != want_kv:
        raise ValueError(f"decode_attention: cache dtype {cache_k.dtype}, "
                         f"expected {want_kv}")
    if any(s.dtype != torch.float32 for s in scales):
        raise ValueError("decode_attention: scales must be float32")
    if q.dim() != 4 or q.shape[1] != 1 or cache_k.dim() != 4 \
            or cache_k.shape != cache_v.shape:
        raise ValueError("decode_attention: q (B, 1, H, dh) and caches "
                         "(B, S, KV, dh) expected")
    B, _, H, dh = q.shape
    if cache_k.shape[0] != B or cache_k.shape[3] != dh or H % cache_k.shape[2]:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(cache_k.shape)} do not match")
    if any(s.shape != cache_k.shape[:3] for s in scales):
        raise ValueError("decode_attention: scales must be (B, S, KV)")
    if dh not in _build.HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {dh} not in "
                         f"{_build.HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: inputs must be contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(B: int, S: int, KV: int, device):
    """Split-K shape: enough CTAs to fill the card, chunks of at least
    ``_MIN_CHUNK`` slots. Returns (n_splits, chunk)."""
    sms = _sm_count(device.index)
    want = max(1, math.ceil(_CTAS_PER_SM * sms / (B * KV)))
    n = max(1, min(want, math.ceil(S / _MIN_CHUNK)))
    chunk = math.ceil(S / n)
    return math.ceil(S / chunk), chunk


def _launch(entry: str, q, ptrs, pos, S, KV, window, ring):
    B, _, H, dh = q.shape
    G = H // KV
    n_splits, chunk = _splits(B, S, KV, q.device)
    o = torch.empty_like(q)
    o_part = torch.empty((B * KV, n_splits, G, dh), dtype=torch.float32,
                         device=q.device)
    ml_part = torch.empty((B * KV, n_splits, G, 2), dtype=torch.float32,
                          device=q.device)
    fn = _build.entry("decode_attention", entry, len(ptrs) + 4, 11)
    err = fn(q.data_ptr(), *ptrs, o.data_ptr(), o_part.data_ptr(),
             ml_part.data_ptr(), _build.DTYPES[q.dtype], B, S, H, KV, dh,
             int(pos), int(window), int(ring), n_splits, chunk, dh ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    return o


def decode_attention(q, cache_k, cache_v, pos, *, window: int = 0,
                     ring: bool = False):
    """Decode attention over a bf16/f32 cache: K2 on a CUDA tensor, the
    plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, pos,
                                      window=window, ring=ring)
    _check(q, cache_k, cache_v, None)
    o = _launch("decode_attention_fwd", q,
                (cache_k.data_ptr(), cache_v.data_ptr()), pos,
                cache_k.shape[1], cache_k.shape[2], window, ring)
    _build.count_launch(decode_attention)
    return o


def decode_attention_quant(q, cache_k, k_scale, cache_v, v_scale, pos, *,
                           window: int = 0, ring: bool = False):
    """Decode attention over an int8 cache: K3 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, cache_k, k_scale, cache_v,
                                            v_scale, pos, window=window,
                                            ring=ring)
    _check(q, cache_k, cache_v, torch.int8, (k_scale, v_scale))
    o = _launch("decode_attention_q8_fwd", q,
                (cache_k.data_ptr(), k_scale.data_ptr(), cache_v.data_ptr(),
                 v_scale.data_ptr()), pos, cache_k.shape[1],
                cache_k.shape[2], window, ring)
    _build.count_launch(decode_attention_quant)
    return o


decode_attention.launches = 0
decode_attention_quant.launches = 0
