"""Decoder-only transformer stack: dense, MoE, hybrid (attention + SSM)
and VLM (port of ``repro.models.transformer``).

Layers are stacked on a leading L dim, as in the reference; a Python loop
over the L slices takes the place of ``jax.lax.scan``. Modes:
  - train:   full sequence, no cache (``forward``, training)
  - prefill: full sequence, returns the KV cache (full or ring)
  - decode:  one token against the cache (serve_step)

A block's kernels come from a ``BlockOps``: ``KERNEL_OPS`` (the default)
sends prefill attention to the flash-attention kernel (K1), decode
attention to the decode kernels (K2, or K3 under ``kv_quant``) and the
hybrid block's SSM recurrence to the SSM scan kernel (K5), whose wrappers
run their plain versions on a CPU tensor; ``PLAIN_OPS`` runs the plain
versions on any device, as the yardstick the kernels are held against.
Its prefill follows the reference's chunk rule: above 2 * PREFILL_CHUNK
positions it attends in query chunks (``attention.chunked_attention``),
so the f32 score matrix is never whole. K1 never holds the scores and
stays one launch at any length. An MoE block's FFN is ``moe.moe_apply``;
a VLM prompt is its patch embeddings followed by its token embeddings.

The kernels are forward-only, as the reference's are, and their wrappers
refuse inputs that autograd records: ``forward`` (training) runs
``PLAIN_OPS`` under autograd, with each block recomputed in the backward
(``common.remat``), the reference's ``jax.checkpoint`` per block.

Unlike the reference's functional updates, prefill fills a fresh cache in
place and ``decode_step`` writes the new entry into the cache it is given
and returns that same cache: the serve loop never reuses an old cache,
and in-place writes save a copy of the whole cache per step. The hybrid
block copies its new SSM and conv states into the cache the same way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssm_scan import ops as ssm_scan_ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamDef, remat, rms_norm, rope,
                                       unstack)
from repro_torch.utils.shardctx import (P, batch_axis, home, local_call,
                                        local_layout, maybe_shard, zeros)

PREFILL_CHUNK = 1024


@dataclass(frozen=True)
class BlockOps:
    prefill: Callable      # (q, k, v, *, causal, window) -> out
    decode: Callable       # (q, ck, cv, pos, *, window, ring) -> out
    decode_quant: Callable  # (q, ck, cks, cv, cvs, pos, *, window, ring)
    ssm_scan: Callable     # (x, dt, a_log, b, c, d_skip, state) -> (y, st)


def prefill_attention_plain(q, k, v, *, causal: bool = True,
                            window: int = 0):
    """The plain prefill attention under the reference's chunk rule
    (``repro/models/transformer.py:112``, ``repro/models/whisper.py:89``):
    query chunks of PREFILL_CHUNK above 2 * PREFILL_CHUNK query positions,
    K1's plain version below. Queries sit at 0..Sq-1 and keys at
    0..Sk-1, as K1 places them (Whisper's cross-attention has Sq != Sk)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq > 2 * PREFILL_CHUNK:
        return attn.chunked_attention(
            q, k, v, torch.arange(Sq, device=q.device),
            torch.arange(Sk, device=q.device), causal=causal, window=window,
            chunk=PREFILL_CHUNK)
    return flash_ops.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)


KERNEL_OPS = BlockOps(flash_ops.flash_attention,
                      decode_ops.decode_attention,
                      decode_ops.decode_attention_quant,
                      ssm_scan_ops.ssm_scan)
PLAIN_OPS = BlockOps(prefill_attention_plain,
                     decode_ops.decode_attention_plain,
                     decode_ops.decode_attention_quant_plain,
                     ssm_scan_ops.ssm_scan_plain)


def _ported_only(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "hybrid", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet: "
            f"see ROADMAP.md section 1")


def decoder_param_table(cfg: ModelConfig) -> Dict:
    _ported_only(cfg)
    d, dh = cfg.d_model, cfg.head_dim
    H, KV, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    layers: Dict[str, ParamDef] = {
        "ln1": ParamDef((L, d), (None, None), init="ones"),
        "wq": ParamDef((L, d, H * dh), (None, None, "model")),
        "wk": ParamDef((L, d, KV * dh), (None, None, "model")),
        "wv": ParamDef((L, d, KV * dh), (None, None, "model")),
        "wo": ParamDef((L, H * dh, d), (None, "model", None)),
        "ln2": ParamDef((L, d), (None, None), init="ones"),
    }
    if cfg.qkv_bias:
        layers["bq"] = ParamDef((L, H * dh), (None, "model"), init="zeros")
        layers["bk"] = ParamDef((L, KV * dh), (None, "model"), init="zeros")
        layers["bv"] = ParamDef((L, KV * dh), (None, "model"), init="zeros")
    if cfg.qk_norm:
        layers["q_norm"] = ParamDef((L, dh), (None, None), init="ones")
        layers["k_norm"] = ParamDef((L, dh), (None, None), init="ones")
    if cfg.is_moe:
        layers.update(moe_mod.moe_param_table(cfg, L))
    else:
        layers["w1"] = ParamDef((L, d, cfg.d_ff), (None, None, "model"))
        layers["w3"] = ParamDef((L, d, cfg.d_ff), (None, None, "model"))
        layers["w2"] = ParamDef((L, cfg.d_ff, d), (None, "model", None))
    if cfg.family == "hybrid":
        layers.update(ssm_mod.ssm_param_table(cfg, L))
        layers["attn_out_norm"] = ParamDef((L, d), (None, None), init="ones")
        layers["ssm_out_norm"] = ParamDef((L, d), (None, None), init="ones")
    table = {
        "emb": ParamDef((cfg.vocab_size, d), ("model", None)),
        "layers": layers,
        "final_norm": ParamDef((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        table["lm_head"] = ParamDef((d, cfg.vocab_size), (None, "model"))
    return table


# --- single block -------------------------------------------------------------


def _qkv(cfg: ModelConfig, p, xn, positions):
    B, S, _ = xn.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = xn @ p["wq"]
    k = xn @ p["wk"]
    v = xn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # under a mesh the flat head dims go to the local attention layout
    # first: DTensor splits a sharded dim only where the heads divide
    b, h = local_layout(B, KV)
    q, k, v = (maybe_shard(t, b, None, h) for t in (q, k, v))
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, KV, dh)
    v = v.reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta, partial=cfg.rope_2d)
    k = rope(k, positions, cfg.rope_theta, partial=cfg.rope_2d)
    return q, k, v


def _mlp(cfg: ModelConfig, p, x):
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    h = maybe_shard(h, batch_axis(), None, "model")
    return h @ p["w2"]


# --- under a mesh -------------------------------------------------------------
#
# The kernels read raw pointers, so a DTensor never reaches a wrapper: the
# attention of a block (its cache writes and its BlockOps call) runs on the
# local shards through ``shard_map_compat`` (torch's ``local_map``), with
# the batch over the data axes and the heads over ``model`` where the kv
# heads divide (the query heads of a kv head stay on its shard), and every
# cache slot on every shard: K2/K3 must not attend over a slice of the
# cache. The reference's decode input shards slots over ``model``
# (``launch.specs.cache_shardings``); ``decode_step`` moves the cache to
# this layout first and returns it so.


def cache_layout(cfg: ModelConfig, name: str, shape) -> P:
    """The local attention layout of a stacked cache leaf (L, B, ...):
    k/v (L, B, S, KV, dh) and their scales (L, B, S, KV) by batch and kv
    head, the hybrid block's states by batch."""
    b, h = local_layout(shape[1], cfg.n_kv_heads)
    if name in ("k", "v", "k_scale", "v_scale"):
        return P(None, b, None, h, None)[:len(shape)]
    return P(None, b)


def to_local_layout(cfg: ModelConfig, cache: Dict) -> Dict:
    """``cache`` with every DTensor leaf in ``cache_layout`` (a no-op for
    plain tensors and leaves already there)."""
    return {k: maybe_shard(t, *cache_layout(cfg, k, t.shape))
            for k, t in cache.items()}


def _attn_branch(cfg: ModelConfig, p, xn, layer_cache, pos, mode,
                 ring: bool, ops: BlockOps):
    B, S, _ = xn.shape
    if mode == "decode":
        positions = torch.full((1,), pos, dtype=torch.int64,
                               device=xn.device)
    else:
        positions = torch.arange(S, device=xn.device)
    q, k, v = _qkv(cfg, p, xn, positions)
    names = [n for n in ("k", "v", "k_scale", "v_scale")
             if mode != "train" and n in layer_cache]
    b, h = local_layout(B, cfg.n_kv_heads)
    qkv = P(b, None, h, None)
    out = local_call(
        lambda q, k, v, *c: _attend(cfg, q, k, v, dict(zip(names, c)), pos,
                                    mode, ring, ops),
        (q, k, v, *(layer_cache[n] for n in names)),
        (qkv, qkv, qkv) + tuple(P(b, None, h, None)[:layer_cache[n].ndim]
                                for n in names), qkv)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    out = maybe_shard(out, batch_axis(), None, "model")
    return out @ p["wo"]


def _attend(cfg: ModelConfig, q, k, v, layer_cache, pos, mode, ring: bool,
            ops: BlockOps):
    """A block's attention on (local) tensors: the cache writes and the
    BlockOps call."""
    S = q.shape[1]
    window = cfg.sliding_window
    if mode in ("train", "prefill"):
        out = ops.prefill(q, k, v, causal=True, window=window)
    if mode == "prefill":
        ck, cv = layer_cache["k"], layer_cache["v"]
        if cfg.kv_quant:
            k, sk = attn.quantize_kv(k)
            v, sv = attn.quantize_kv(v)
        if ring:
            W = ck.shape[1]
            tail = min(S, W)
            attn.cache_write_ring(ck, cv, k[:, S - tail:], v[:, S - tail:],
                                  S - tail)
            if cfg.kv_quant:
                attn.cache_write_ring(
                    layer_cache["k_scale"], layer_cache["v_scale"],
                    sk[:, S - tail:], sv[:, S - tail:], S - tail)
        else:
            attn.cache_write_full(ck, cv, k, v, 0)
            if cfg.kv_quant:
                attn.cache_write_full(layer_cache["k_scale"],
                                      layer_cache["v_scale"], sk, sv, 0)
    elif mode == "decode":
        ck, cv = layer_cache["k"], layer_cache["v"]
        if cfg.kv_quant:
            k, sk = attn.quantize_kv(k)
            v, sv = attn.quantize_kv(v)
        # The reference writes with dynamic_update_slice, which clamps the
        # start index into the cache: a full cache sized to the prompt
        # (JaxEndpoint's CachePlan("full", serve_seq)) takes every decode
        # step past its end in its LAST slot. Mirrored here on purpose.
        idx = (pos % ck.shape[1]) if ring else min(pos, ck.shape[1] - 1)
        ck[:, idx] = k[:, 0].to(ck.dtype)
        cv[:, idx] = v[:, 0].to(cv.dtype)
        if cfg.kv_quant:
            cks, cvs = layer_cache["k_scale"], layer_cache["v_scale"]
            cks[:, idx] = sk[:, 0]
            cvs[:, idx] = sv[:, 0]
            # the reference dequantizes the whole cache to compute_dtype,
            # then attends; K3 reads the int8 values exactly, scales the
            # f32 scores by k_scale and rounds p * v_scale to the compute
            # type -- equal in f32 up to summation order, rounding-level
            # apart in bf16
            out = ops.decode_quant(q, ck, cks, cv, cvs, pos, window=window,
                                   ring=ring)
        else:
            out = ops.decode(q, ck, cv, pos, window=window, ring=ring)
    return out


def block_apply(cfg: ModelConfig, p, x, layer_cache, pos, mode,
                ring: bool, ops: BlockOps = KERNEL_OPS):
    """One decoder block. Returns (x, aux): an MoE block's load-balance
    loss, else None (the callers of prefill and decode drop it, as the
    reference's do). Prefill and decode write the block's kv entries (and
    a hybrid block's SSM and conv states) into ``layer_cache``; ``mode ==
    "train"`` takes no cache and writes nothing, and a hybrid block's SSM
    heads start from zero states."""
    # a sequence-parallel carry is gathered here, where the products need
    # every position (GSPMD's gather inside the reference's block)
    x = maybe_shard(x, batch_axis())
    xn = rms_norm(x, p["ln1"])
    attn_out = _attn_branch(cfg, p, xn, layer_cache, pos, mode, ring, ops)
    if cfg.family == "hybrid":
        if mode == "train":
            st = ssm_mod.ssm_state_shapes(cfg, x.shape[0])
            b, _ = local_layout(x.shape[0], 1)
            ssm_state, conv_state = (
                zeros(s, d, home(x), P(b))
                for s, d in (st["ssm_state"], st["conv_state"]))
        else:
            ssm_state = layer_cache["ssm_state"]
            conv_state = layer_cache["conv_state"]
        # the SSM heads read the same normed input as attention
        ssm_out, ssm_state, conv_state = ssm_mod.ssm_apply_seq(
            cfg, p, xn, ssm_state, conv_state, ops.ssm_scan)
        if mode != "train":
            layer_cache["ssm_state"].copy_(ssm_state)
            layer_cache["conv_state"].copy_(conv_state)
        x = x + 0.5 * (rms_norm(attn_out, p["attn_out_norm"])
                       + rms_norm(ssm_out, p["ssm_out_norm"]))
    else:
        x = x + attn_out
    xn2 = rms_norm(x, p["ln2"])
    aux = None
    if cfg.is_moe:
        ffn_out, aux = moe_mod.moe_apply_ep(cfg, p, xn2)
    else:
        ffn_out = _mlp(cfg, p, xn2)
    return x + ffn_out, aux


# --- cache --------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int,
                 ring: bool) -> Dict:
    """Shapes/dtypes of the serve cache (leading dim L on every leaf)."""
    _ported_only(cfg)
    L, KV, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    dt = torch.int8 if cfg.kv_quant else cfg.compute_dtype
    shapes = {
        "k": ((L, batch, cache_len, KV, dh), dt),
        "v": ((L, batch, cache_len, KV, dh), dt),
    }
    if cfg.kv_quant:
        shapes["k_scale"] = ((L, batch, cache_len, KV), torch.float32)
        shapes["v_scale"] = ((L, batch, cache_len, KV), torch.float32)
    if cfg.family == "hybrid":
        st = ssm_mod.ssm_state_shapes(cfg, batch)
        for name, (s, d) in st.items():
            shapes[name] = ((L,) + s, d)
    return shapes


def zero_cache(cfg: ModelConfig, batch: int, cache_len: int, ring: bool,
               device) -> Dict:
    """Zero cache leaves on ``device``; under a mesh, when ``device`` is a
    DeviceMesh, DTensors in ``cache_layout``."""
    shapes = cache_shapes(cfg, batch, cache_len, ring)
    return {k: zeros(s, d, device, cache_layout(cfg, k, s))
            for k, (s, d) in shapes.items()}


# --- full stack ----------------------------------------------------------------

def _layer(tree: Dict, i: int) -> Dict:
    return {k: t[i] for k, t in tree.items()}


def _embed(cfg: ModelConfig, params, tokens, patch_embeds=None):
    # F.embedding, the gather of emb[tokens]: DTensor shards it over a
    # vocab-sharded table with one all-reduce
    x = maybe_shard(F.embedding(tokens.long(), params["emb"]), batch_axis())
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return maybe_shard(x.to(cfg.compute_dtype), batch_axis())


def _unembed(cfg: ModelConfig, params, x):
    x = maybe_shard(rms_norm(x, params["final_norm"]), batch_axis())
    head = params["emb"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    return maybe_shard(logits, batch_axis(), None, "model")


def forward(cfg: ModelConfig, params, tokens, patch_embeds=None,
            ops: BlockOps = PLAIN_OPS):
    """Teacher-forced logits over the full sequence (a VLM's: its patch
    embeddings, then its tokens) and the summed MoE aux loss (float32
    zero for the other families): the training forward. Each block is
    recomputed in the backward (``common.remat``)."""
    _ported_only(cfg)
    x = _embed(cfg, params, tokens, patch_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(p, x):
        # sequence-parallel carry: the checkpoint saved per layer is
        # (B, S/model, d) instead of (B, S, d), gathered inside the block
        x = maybe_shard(x, batch_axis(), "model")
        x, a = block_apply(cfg, p, x, None, 0, "train", False, ops)
        return maybe_shard(x, batch_axis(), "model"), a
    for p in unstack(params["layers"], cfg.n_layers):
        x, a = remat(block, p, x)
        if a is not None:
            aux = aux + a
    return _unembed(cfg, params, x), aux


def prefill(cfg: ModelConfig, params, tokens, patch_embeds=None,
            cache_len: Optional[int] = None, ring: bool = False,
            ops: BlockOps = KERNEL_OPS):
    """Run the prompt (a VLM's: ``patch_embeds`` (B, n_patches, d), then
    ``tokens``), return (last-position logits, serve cache)."""
    _ported_only(cfg)
    x = _embed(cfg, params, tokens, patch_embeds)
    B, S, _ = x.shape
    cache_len = cache_len or S
    cache = zero_cache(cfg, B, cache_len, ring, home(x))
    for i in range(cfg.n_layers):
        x = maybe_shard(x, batch_axis(), "model")  # sequence-parallel carry
        x, _ = block_apply(cfg, _layer(params["layers"], i), x,
                           _layer(cache, i), 0, "prefill", ring, ops)
    logits = _unembed(cfg, params, x[:, -1:])
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int,
                ring: bool = False, ops: BlockOps = KERNEL_OPS):
    """One serve step: tokens (B,1) at absolute position ``pos``. Writes
    the new kv entries into ``cache`` and returns (logits, cache); under a
    mesh, a DTensor cache is first moved to ``cache_layout`` and the
    returned cache is that one."""
    _ported_only(cfg)
    x = _embed(cfg, params, tokens)
    cache = to_local_layout(cfg, cache)
    for i in range(cfg.n_layers):
        x, _ = block_apply(cfg, _layer(params["layers"], i), x,
                           _layer(cache, i), pos, "decode", ring, ops)
    logits = _unembed(cfg, params, x)
    return logits[:, 0], cache
