"""Whisper-style encoder-decoder backbone (port of ``repro.models.whisper``,
arXiv:2212.04356).

The mel-spectrogram + conv feature extractor is a STUB, as in the
reference: callers provide precomputed frame embeddings (B, encoder_len,
d_model). The encoder is bidirectional with sinusoidal positions; the
decoder is causal with a learned position table (``cfg.max_positions``)
and cross-attention in every layer. LayerNorm with bias and GELU MLPs.

Layers are stacked on a leading L dim; a Python loop over the L slices
takes the place of ``jax.lax.scan``. Attention comes from a
``transformer.BlockOps``: with ``KERNEL_OPS`` the encoder's
self-attention (non-causal, Sq = Sk = encoder_len), the decoder
prefill's self-attention (causal) and its cross-attention (non-causal,
Sq = the prompt, Sk = encoder_len) run on K1; a decode step's
self-attention runs on K2 over the self cache and its cross-attention,
one query over every frame, on K2 at ``pos = encoder_len - 1`` over the
full cross cache (so every slot is valid); under ``kv_quant`` both run
on K3 over the int8 caches. ``PLAIN_OPS`` runs the plain versions;
``forward`` (training) runs them by default, under autograd.

The serve cache holds the self k/v (``k``, ``v``: ``cache_len`` slots)
and the cross k/v (``ck``, ``cv``: ``encoder_len`` slots, written once by
prefill from the encoder's output), plus their f32 scales under
``kv_quant``. Prefill fills a fresh cache in place and ``decode_step``
writes into the cache it is given, as ``models.transformer`` does.

Under a mesh each encoder and decoder block runs on the local batch shard
with its weights gathered (``shardctx.batch_local``), the kernels on
local tensors, and the cache is split by batch over the data axes
(``decode_step`` moves a cache in the reference's layout there first).
Embedding, carry and logits keep the reference's constraints.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import ParamDef, layer_norm, remat, unstack
from repro_torch.models.transformer import (KERNEL_OPS, PLAIN_OPS, BlockOps,
                                            _layer)
from repro_torch.utils.shardctx import (P, batch_axis, batch_local, home,
                                        local_layout, maybe_shard, zeros)


def _attn_defs(L, d, H, dh, prefix=""):
    return {
        prefix + "ln_w": ParamDef((L, d), (None, None), init="ones"),
        prefix + "ln_b": ParamDef((L, d), (None, None), init="zeros"),
        prefix + "wq": ParamDef((L, d, H * dh), (None, None, "model")),
        prefix + "wk": ParamDef((L, d, H * dh), (None, None, "model")),
        prefix + "wv": ParamDef((L, d, H * dh), (None, None, "model")),
        prefix + "wo": ParamDef((L, H * dh, d), (None, "model", None)),
    }


def _mlp_defs(L, d, f, prefix=""):
    return {
        prefix + "mln_w": ParamDef((L, d), (None, None), init="ones"),
        prefix + "mln_b": ParamDef((L, d), (None, None), init="zeros"),
        prefix + "w1": ParamDef((L, d, f), (None, None, "model")),
        prefix + "b1": ParamDef((L, f), (None, "model"), init="zeros"),
        prefix + "w2": ParamDef((L, f, d), (None, "model", None)),
        prefix + "b2": ParamDef((L, d), (None, None), init="zeros"),
    }


def whisper_param_table(cfg: ModelConfig) -> Dict:
    d, dh, H = cfg.d_model, cfg.head_dim, cfg.n_heads
    Le, Ld, f = cfg.n_encoder_layers, cfg.n_layers, cfg.d_ff
    enc = {**_attn_defs(Le, d, H, dh), **_mlp_defs(Le, d, f)}
    dec = {**_attn_defs(Ld, d, H, dh),
           **_attn_defs(Ld, d, H, dh, prefix="x_"),
           **_mlp_defs(Ld, d, f)}
    return {
        "emb": ParamDef((cfg.vocab_size, d), ("model", None)),
        "dec_pos": ParamDef((cfg.max_positions, d), (None, None),
                            scale=0.02),
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_norm_w": ParamDef((d,), (None,), init="ones"),
        "enc_norm_b": ParamDef((d,), (None,), init="zeros"),
        "dec_norm_w": ParamDef((d,), (None,), init="ones"),
        "dec_norm_b": ParamDef((d,), (None,), init="zeros"),
    }


def _sinusoid(S: int, d: int, device=None):
    """The encoder's positions, in f32: the exponent divides by
    max(d // 2 - 1, 1), as the reference's does. The power 10000^e is
    taken in f64 and rounded to f32, the correctly rounded value that
    XLA's f32 pow gives (torch's f32 pow is 1 ulp off at some e, which
    moves sin(pos / .) by up to 2.4e-4 at pos 1499)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    e = dim / max(d // 2 - 1, 1)
    ang = pos / (10_000.0 ** e.double()).float()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _gelu(x):
    # jax.nn.gelu, which the reference calls, defaults to the tanh
    # approximation; torch's F.gelu defaults to the exact erf form
    return F.gelu(x, approximate="tanh")


def _mlp(p, x):
    xn = layer_norm(x, p["mln_w"], p["mln_b"])
    h = _gelu(xn @ p["w1"] + p["b1"])
    return x + (h @ p["w2"] + p["b2"])


def _heads(cfg: ModelConfig, x):
    B, S, _ = x.shape
    return x.reshape(B, S, cfg.n_heads, cfg.head_dim)


def _mha(cfg: ModelConfig, p, xq, k, v, *, causal: bool, ops: BlockOps,
         prefix: str = ""):
    """Prefill attention of xq's queries over k, v (B, Sk, H, dh): K1
    (or the plain version, under the reference's chunk rule), queries at
    0..Sq-1 and keys at 0..Sk-1; returns the output projection."""
    B, Sq, _ = xq.shape
    q = _heads(cfg, xq @ p[prefix + "wq"])
    out = ops.prefill(q, k, v, causal=causal, window=0)
    return out.reshape(B, Sq, -1) @ p[prefix + "wo"]


def _self_mha(cfg, p, xn, *, causal, ops, prefix=""):
    k = _heads(cfg, xn @ p[prefix + "wk"])
    v = _heads(cfg, xn @ p[prefix + "wv"])
    return _mha(cfg, p, xn, k, v, causal=causal, ops=ops, prefix=prefix), \
        (k, v)


def encode(cfg: ModelConfig, params, frames, ops: BlockOps = KERNEL_OPS):
    """frames: (B, encoder_len, d_model) stub embeddings -> encoder output."""
    x = frames.to(cfg.compute_dtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    x = maybe_shard(x, batch_axis())

    def block(p, x):
        xn = layer_norm(x, p["ln_w"], p["ln_b"])
        a, _ = _self_mha(cfg, p, xn, causal=False, ops=ops)
        return _mlp(p, x + a)
    for p in unstack(params["enc_layers"], cfg.n_encoder_layers):
        x = remat(batch_local, block, p, (x,), 1)
    return layer_norm(x, params["enc_norm_w"], params["enc_norm_b"])


def _write(cache, idx, new):
    cache[:, idx] = new[:, 0].to(cache.dtype)


def _dec_block(cfg: ModelConfig, p, x, layer_cache, pos: int, mode: str,
               ops: BlockOps):
    """One decoder block. ``layer_cache`` holds the self k/v (and scales)
    and the filled cross k/v (``ck``, ``cv``); prefill writes its self
    k/v into it, decode its new entry. ``mode == "train"`` takes the
    encoder output as ``layer_cache["enc"]`` and writes nothing."""
    B = x.shape[0]
    xn = layer_norm(x, p["ln_w"], p["ln_b"])
    if mode == "train":
        a, _ = _self_mha(cfg, p, xn, causal=True, ops=ops)
    elif mode == "prefill":
        # attends over the fresh, unquantized k/v, as the reference does
        a, (k, v) = _self_mha(cfg, p, xn, causal=True, ops=ops)
        if cfg.kv_quant:
            k, sk = attn.quantize_kv(k)
            v, sv = attn.quantize_kv(v)
            attn.cache_write_full(layer_cache["k_scale"],
                                  layer_cache["v_scale"], sk, sv, 0)
        attn.cache_write_full(layer_cache["k"], layer_cache["v"], k, v, 0)
    else:  # decode
        q = _heads(cfg, xn @ p["wq"])
        k = _heads(cfg, xn @ p["wk"])
        v = _heads(cfg, xn @ p["wv"])
        ck, cv = layer_cache["k"], layer_cache["v"]
        if cfg.kv_quant:
            k, sk = attn.quantize_kv(k)
            v, sv = attn.quantize_kv(v)
        # the reference's dynamic_update_slice clamps the start into the
        # cache: a cache sized to the prompt takes every step past its
        # end in its last slot (as models.transformer mirrors it)
        idx = min(pos, ck.shape[1] - 1)
        _write(ck, idx, k)
        _write(cv, idx, v)
        if cfg.kv_quant:
            cks, cvs = layer_cache["k_scale"], layer_cache["v_scale"]
            _write(cks, idx, sk)
            _write(cvs, idx, sv)
            out = ops.decode_quant(q, ck, cks, cv, cvs, pos)
        else:
            out = ops.decode(q, ck, cv, pos)
        a = out.reshape(B, 1, -1) @ p["wo"]
    x = x + a

    # cross-attention over the encoder's k/v
    xn = layer_norm(x, p["x_ln_w"], p["x_ln_b"])
    if mode == "train":
        enc = layer_cache["enc"]
        xk = _heads(cfg, enc @ p["x_wk"])
        xv = _heads(cfg, enc @ p["x_wv"])
        a = _mha(cfg, p, xn, xk, xv, causal=False, ops=ops, prefix="x_")
    elif mode == "prefill":
        xk, xv = layer_cache["ck"], layer_cache["cv"]
        if cfg.kv_quant:
            # K1 takes bf16 and f32: the int8 cache dequantized to the
            # compute type first, as the reference attends
            xk = attn.dequantize_kv(xk, layer_cache["ck_scale"],
                                    cfg.compute_dtype)
            xv = attn.dequantize_kv(xv, layer_cache["cv_scale"],
                                    cfg.compute_dtype)
        a = _mha(cfg, p, xn, xk, xv, causal=False, ops=ops, prefix="x_")
    else:
        # one query at position 0, non-causal, over every frame: K2 (K3)
        # at pos = encoder_len - 1 on the full cache, whose every slot
        # is then valid
        q = _heads(cfg, xn @ p["x_wq"])
        last = layer_cache["ck"].shape[1] - 1
        if cfg.kv_quant:
            out = ops.decode_quant(q, layer_cache["ck"],
                                   layer_cache["ck_scale"], layer_cache["cv"],
                                   layer_cache["cv_scale"], last)
        else:
            out = ops.decode(q, layer_cache["ck"], layer_cache["cv"], last)
        a = out.reshape(B, 1, -1) @ p["x_wo"]
    return _mlp(p, x + a)


def _dec_embed(cfg: ModelConfig, params, tokens, pos: int):
    x = F.embedding(tokens.long(), params["emb"]).to(cfg.compute_dtype)
    x = maybe_shard(x, batch_axis())
    S = tokens.shape[1]
    # dynamic_slice_in_dim clamps the start to max_positions - S
    start = max(0, min(pos, params["dec_pos"].shape[0] - S))
    return maybe_shard(x + params["dec_pos"][start:start + S].to(x.dtype),
                       batch_axis())


def _unembed(params, x):
    x = layer_norm(x, params["dec_norm_w"], params["dec_norm_b"])
    x = maybe_shard(x, batch_axis())
    return maybe_shard(x @ params["emb"].T.to(x.dtype), batch_axis(), None,
                       "model")


def forward(cfg: ModelConfig, params, tokens, frames,
            ops: BlockOps = PLAIN_OPS):
    """Teacher-forced decoder logits (B, S, vocab), the encoder run
    inline; with the reference's zero aux loss. The training forward:
    each encoder and decoder block is recomputed in the backward
    (``common.remat``)."""
    enc = encode(cfg, params, frames, ops)
    x = _dec_embed(cfg, params, tokens, 0)

    def block(p, x, enc):
        return _dec_block(cfg, p, x, {"enc": enc}, 0, "train", ops)
    for p in unstack(params["dec_layers"], cfg.n_layers):
        x = maybe_shard(x, batch_axis(), "model")  # sequence-parallel carry
        x = remat(batch_local, block, p, (x, enc), 1)
    return _unembed(params, x), torch.zeros((), device=x.device)


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    L, H, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    dt = torch.int8 if cfg.kv_quant else cfg.compute_dtype
    shapes = {
        "k": ((L, batch, cache_len, H, dh), dt),
        "v": ((L, batch, cache_len, H, dh), dt),
        "ck": ((L, batch, cfg.encoder_len, H, dh), dt),
        "cv": ((L, batch, cfg.encoder_len, H, dh), dt),
    }
    if cfg.kv_quant:  # per-(token, head) f32 scales
        shapes["k_scale"] = ((L, batch, cache_len, H), torch.float32)
        shapes["v_scale"] = ((L, batch, cache_len, H), torch.float32)
        shapes["ck_scale"] = ((L, batch, cfg.encoder_len, H), torch.float32)
        shapes["cv_scale"] = ((L, batch, cfg.encoder_len, H), torch.float32)
    return shapes


def zero_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Dict:
    """Zero cache leaves on ``device``; under a mesh, when ``device`` is a
    DeviceMesh, DTensors split by batch (``cache_layout``)."""
    return {k: zeros(s, d, device, cache_layout(s))
            for k, (s, d) in cache_shapes(cfg, batch, cache_len).items()}


def cache_layout(shape) -> P:
    """Every leaf (L, B, ...) split by batch over the data axes."""
    return P(None, local_layout(shape[1], 1)[0])


def _layer_local(p, x, lc, names, body):
    """``body(p, x, layer_cache) -> x`` on the local batch shard under a
    mesh, the layer cache's leaves ``names`` passed as local views so
    the body's in-place writes land in the cache."""
    def local(p, x, *leaves):
        return body(p, x, dict(zip(names, leaves)))
    return batch_local(local, p, (x, *(lc[n] for n in names)), 1)


def prefill(cfg: ModelConfig, params, tokens, frames,
            cache_len: Optional[int] = None, ops: BlockOps = KERNEL_OPS):
    """Encode the audio, fill each layer's cross cache from the encoder's
    output, prefill the decoder prompt; returns (last-position logits,
    serve cache)."""
    enc = encode(cfg, params, frames, ops)
    B, S = tokens.shape
    cache = zero_cache(cfg, B, cache_len or S, home(enc))
    x = _dec_embed(cfg, params, tokens, 0)

    def body(p, x, lc):
        enc = lc.pop("enc")
        ck = _heads(cfg, enc @ p["x_wk"])
        cv = _heads(cfg, enc @ p["x_wv"])
        if cfg.kv_quant:
            ck, cks = attn.quantize_kv(ck)
            cv, cvs = attn.quantize_kv(cv)
            lc["ck_scale"].copy_(cks)
            lc["cv_scale"].copy_(cvs)
        lc["ck"].copy_(ck)
        lc["cv"].copy_(cv)
        return _dec_block(cfg, p, x, lc, 0, "prefill", ops)
    for i in range(cfg.n_layers):
        lc = dict(_layer(cache, i), enc=enc)
        x = _layer_local(_layer(params["dec_layers"], i), x, lc,
                         sorted(lc), body)
    logits = _unembed(params, x[:, -1:])
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int,
                ops: BlockOps = KERNEL_OPS):
    """One serve step: tokens (B, 1) at position ``pos``. Writes the new
    self k/v entries into ``cache`` and returns (logits, cache)."""
    x = _dec_embed(cfg, params, tokens, pos)
    cache = {k: maybe_shard(t, *cache_layout(t.shape))
             for k, t in cache.items()}

    def body(p, x, lc):
        return _dec_block(cfg, p, x, lc, pos, "decode", ops)
    for i in range(cfg.n_layers):
        lc = _layer(cache, i)
        x = _layer_local(_layer(params["dec_layers"], i), x, lc,
                         sorted(lc), body)
    logits = _unembed(params, x)
    return logits[:, 0], cache
