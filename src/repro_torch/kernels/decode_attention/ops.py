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
from repro_torch.models.attention import (NEG_INF, decode_attention as
                                          _model_decode_attention,
                                          dequantize_kv, full_slot_positions,
                                          ring_slot_positions)

SLOT_TILE = 32           # K2, K3: cache slots per warp tile, one per lane
MAX_CLUSTER = 8          # K2, K3: CTAs per cluster, the portable limit
_K2_CTAS_PER_SM = 2      # K2: target CTAs per SM
# K3: target CTAs per SM; its int8 tiles take half K2's shared memory, so
# twice as many fit
_K3_CTAS_PER_SM = 4
MAX_GROUP = 8            # K2, K3: query heads per kv head in one launch


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


def decode_attention_quant_as_kernel(q, cache_k, k_scale, cache_v, v_scale,
                                     pos, *, window: int = 0,
                                     ring: bool = False):
    """K3's arithmetic, in plain PyTorch (tests only): the int8 values
    exactly, scores q . k8 in f32 times the slot's k scale and dh^-0.5,
    the masked softmax's p in f32 summed into l, and p times the slot's v
    scale against v8 -- rounded to bf16 when q is bf16, as the tensor-core
    pass rounds it, in f32 otherwise; the output in q's type. The kernel
    takes p against its running max, this against the row's max: the
    rounding of p is the same to its relative error."""
    B, _, H, dh = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    sp = (ring_slot_positions(pos + 1, S, q.device) if ring
          else full_slot_positions(pos, S, q.device))
    valid = (sp >= 0) & (sp <= pos)
    if window:
        valid &= sp > pos - window
    qg = q.float().reshape(B, KV, H // KV, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float())
    s = s * (k_scale.permute(0, 2, 1)[:, :, None] * dh ** -0.5)
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    pv = p * v_scale.permute(0, 2, 1)[:, :, None]
    if q.dtype == torch.bfloat16:
        pv = pv.to(torch.bfloat16).float()
    out = torch.einsum("bkgs,bskd->bkgd", pv, cache_v.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, H, dh).to(q.dtype)


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
    if any(t.data_ptr() % 16 for t in (q, cache_k, cache_v)):
        raise ValueError("decode_attention: q and the caches must be "
                         "16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_plan(B: int, S: int, KV: int, sms: int,
                 ctas_per_sm: int = _K2_CTAS_PER_SM):
    """K2's launch shape on a card of ``sms`` SMs: one cluster of
    ``n_ctas`` (1 to ``MAX_CLUSTER``) CTAs per (batch, kv head) row, about
    ``ctas_per_sm`` CTAs per SM in all, each CTA over ``chunk``
    consecutive slots and at least one ``SLOT_TILE`` of them when S allows.
    Returns (n_ctas, chunk): CTA r takes slots [r * chunk, min(S, (r + 1)
    * chunk)), and every CTA's range is non-empty."""
    want = math.ceil(ctas_per_sm * sms / (B * KV))
    n = max(1, min(MAX_CLUSTER, want, S // SLOT_TILE))
    chunk = math.ceil(S / n)
    return math.ceil(S / chunk), chunk


def quant_plan(B: int, S: int, KV: int, sms: int):
    """K3's launch shape: ``cluster_plan`` at ``_K3_CTAS_PER_SM`` CTAs per
    SM."""
    return cluster_plan(B, S, KV, sms, _K3_CTAS_PER_SM)


def sub_groups(G: int) -> int:
    """The fewest sub-groups, each of at most ``MAX_GROUP`` query heads and
    all of one size, that a kv head's group of G query heads splits into:
    K2 launches once per sub-group (heads q0 .. q0 + G / n - 1 of every
    group), reading q and writing the output in place."""
    n = -(-G // MAX_GROUP)
    while G % n:
        n += 1
    return n


def _launch(name, plan, q, caches, pos, window, ring):
    """K2 (``caches`` = k, v) or K3 (k, k_scale, v, v_scale) through the C
    entry ``name``: one launch per sub-group of g query heads of each kv
    head's group, reading q and writing the output in place."""
    B, _, H, dh = q.shape
    S, KV = caches[0].shape[1], caches[0].shape[2]
    G = H // KV
    g = G // sub_groups(G)
    n_ctas, chunk = plan(B, S, KV, _sm_count(q.device.index))
    o = torch.empty_like(q)
    fn = _build.entry("decode_attention", name, len(caches) + 2, 13)
    ptrs = [q.data_ptr()] + [t.data_ptr() for t in caches] + [o.data_ptr()]
    for q0 in range(0, G, g):
        err = fn(*ptrs, _build.DTYPES[q.dtype], B, S, KV * g, KV, G, q0, dh,
                 int(pos), int(window), int(ring), n_ctas, chunk, dh ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, name)
    return o


def decode_attention(q, cache_k, cache_v, pos, *, window: int = 0,
                     ring: bool = False):
    """Decode attention over a bf16/f32 cache: K2 on a CUDA tensor, the
    plain version on a CPU tensor; raises if autograd would record an
    input."""
    _build.refuse_autograd("decode_attention", q, cache_k, cache_v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, pos,
                                      window=window, ring=ring)
    _check(q, cache_k, cache_v, None)
    o = _launch("decode_attention_group_fwd", cluster_plan, q,
                (cache_k, cache_v), pos, window, ring)
    _build.count_launch(decode_attention)
    return o


def decode_attention_quant(q, cache_k, k_scale, cache_v, v_scale, pos, *,
                           window: int = 0, ring: bool = False):
    """Decode attention over an int8 cache: K3 on a CUDA tensor, the plain
    version on a CPU tensor; raises if autograd would record an input."""
    _build.refuse_autograd("decode_attention_quant", q, cache_k, k_scale,
                           cache_v, v_scale)
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, cache_k, k_scale, cache_v,
                                            v_scale, pos, window=window,
                                            ring=ring)
    _check(q, cache_k, cache_v, torch.int8, (k_scale, v_scale))
    o = _launch("decode_attention_q8_fwd", quant_plan, q,
                (cache_k, k_scale, cache_v, v_scale), pos, window, ring)
    _build.count_launch(decode_attention_quant)
    return o


decode_attention.launches = 0
decode_attention_quant.launches = 0
