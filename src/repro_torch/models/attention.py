"""Attention: GQA full/causal/sliding-window attention, chunked prefill,
int8 KV quantization, KV caches and cached decode, in plain PyTorch.

These are the port of ``repro.models.attention`` and the plain versions
the CUDA kernels are held against. The model (``models.transformer``)
routes prefill attention to the flash-attention kernel (K1) and decode
attention to the decode kernels (K2, K3); on a CPU tensor those wrappers
run the plain versions built from the functions here.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _scores(q, k, scale):
    # q: (B, Sq, KV, G, dh)  k: (B, Sk, KV, dh) -> (B, KV, G, Sq, Sk) f32
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def _combine(w, v):
    # w: (B, KV, G, Sq, Sk)  v: (B, Sk, KV, dh) -> (B, Sq, KV, G, dh)
    return torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)


def masked_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                     window: int = 0, scale: Optional[float] = None):
    """Attention with positional masking.

    q: (B, Sq, H, dh) grouped into (KV, G); k/v: (B, Sk, KV, dh).
    q_pos: (Sq,) absolute positions of queries; k_pos: (Sk,) of keys
    (entries < 0 are invalid slots, e.g. unfilled ring-buffer slots).
    """
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, dh)
    scale = scale if scale is not None else dh ** -0.5
    s = _scores(qg, k, scale)  # (B, KV, G, Sq, Sk) f32
    mask = k_pos[None, :] >= 0
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(mask[None, None, None], s,
                    torch.full((), NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    out = _combine(w, v)
    return out.reshape(B, Sq, H, dh)


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                      window: int = 0, chunk: int = 1024):
    """Query-chunked attention: peak memory O(chunk * Sk) instead of
    O(Sq * Sk) for the f32 scores, the same function as
    ``masked_attention`` (to which it falls back when Sq is not a multiple
    of ``chunk`` or not above it, as the reference does)."""
    B, Sq, H, dh = q.shape
    if Sq % chunk or Sq <= chunk:
        return masked_attention(q, k, v, q_pos, k_pos,
                                causal=causal, window=window)
    return torch.cat([
        masked_attention(q[:, i:i + chunk], k, v, q_pos[i:i + chunk], k_pos,
                         causal=causal, window=window)
        for i in range(0, Sq, chunk)], dim=1)


# --- int8 KV quantization (beyond-paper, §Perf H5) -----------------------------

def quantize_kv(x):
    """Per-(batch, position, kv-head) symmetric int8: x (B, S, KV, dh) ->
    (int8 values, f32 scales (B, S, KV))."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.round(x32 / scale[..., None])
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


# --- KV caches ---------------------------------------------------------------

def ring_slot_positions(pos, W: int, device=None):
    """Positions held by ring-buffer slots after writes 0..pos-1.

    Slot i holds the latest position p <= pos-1 with p % W == i, or -1 if
    that slot has never been written.
    """
    i = torch.arange(W, device=device)
    last = pos - 1
    p = last - torch.remainder(last - i, W)
    return torch.where((p >= 0) & (p <= last), p, torch.full_like(p, -1))


def full_slot_positions(pos, S: int, device=None):
    """Positions held by a full cache of S slots when the query is at
    ``pos``: slot i holds position i if i <= pos, else -1."""
    i = torch.arange(S, device=device)
    return torch.where(i <= pos, i, torch.full_like(i, -1))


def cache_write_full(cache_k, cache_v, k, v, pos):
    """Write S new kv entries at [pos, pos+S) of a full cache (B,Smax,KV,dh),
    in place; returns the caches."""
    S = k.shape[1]
    cache_k[:, pos:pos + S] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + S] = v.to(cache_v.dtype)
    return cache_k, cache_v


def cache_write_ring(cache_k, cache_v, k, v, pos):
    """Write S new entries into a ring cache (B, W, KV, dh) at slots
    (pos+j) % W, in place; returns the caches."""
    W = cache_k.shape[1]
    S = k.shape[1]
    idx = torch.remainder(pos + torch.arange(S, device=cache_k.device), W)
    cache_k[:, idx] = k.to(cache_k.dtype)
    cache_v[:, idx] = v.to(cache_v.dtype)
    return cache_k, cache_v


def decode_attention(q, cache_k, cache_v, pos, *, window: int = 0,
                     ring: bool = False):
    """Single-position decode: q (B, 1, H, dh) against a cache.

    ``pos`` is the absolute position of the query token; the cache holds
    positions < pos (+ the current token is written by the caller before
    calling, so k_pos <= pos are valid).
    """
    S = cache_k.shape[1]
    if ring:
        k_pos = ring_slot_positions(pos + 1, S, q.device)
    else:
        k_pos = full_slot_positions(pos, S, q.device)
    q_pos = torch.full((1,), pos, dtype=torch.int64, device=q.device)
    return masked_attention(q, cache_k, cache_v, q_pos, k_pos,
                            causal=True, window=window)
