"""Selective-state-space (Mamba-style) heads for the hybrid (Hymba) arch
(port of ``repro.models.ssm``).

Per-head scalar decay A, state size N (= cfg.ssm_state), depthwise causal
conv front-end. The recurrence runs through the scan the caller passes:
the model passes its ops' ``ssm_scan``, which is the SSM scan kernel (K5,
``kernels/ssm_scan``) or its plain version (training: the kernel is
forward-only). The reference's two-level chunked time scan exists for
reverse-mode memory and computes the same sum: here the scan runs whole,
and in chunks recomputed in the backward while autograd records
(``common.time_chunks``). Under a mesh the scan runs on the local
shards (``shardctx.local_call``): the batch over the data axes, the heads
over ``model`` where they divide.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, time_chunks
from repro_torch.utils.shardctx import (P, Reduced, local_call, local_layout,
                                        maybe_shard, summed_over)


def ssm_param_table(cfg: ModelConfig, L: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    Hs, Ps, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = Hs * Ps
    cw = cfg.conv_width
    return {
        "in_proj": ParamDef((L, d, di), (None, None, "model")),
        "conv_w": ParamDef((L, cw, di), (None, None, "model"), init="normal",
                           scale=cw ** -0.5),
        "dt_proj": ParamDef((L, d, Hs), (None, None, None)),
        "dt_bias": ParamDef((L, Hs), (None, None), init="zeros"),
        "b_proj": ParamDef((L, d, N), (None, None, None)),
        "c_proj": ParamDef((L, d, N), (None, None, None)),
        "a_log": ParamDef((L, Hs), (None, None), init="zeros"),
        "d_skip": ParamDef((L, Hs), (None, None), init="ones"),
        "out_proj": ParamDef((L, di, d), (None, "model", None)),
    }


def causal_conv(xin, conv_state, w):
    """xin (B,S,di), conv_state (B,cw-1,di), w (cw,di).
    out[t] = sum_j w[j] * xp[t+j] with xp = [state, xin], summed in order
    j = 0..cw-1 in xin's dtype; the new state is xp's last cw-1 rows."""
    cw = w.shape[0]
    S = xin.shape[1]
    xp = torch.cat([conv_state.to(xin.dtype), xin], dim=1)
    out = xp[:, :S] * w[0]
    for j in range(1, cw):
        out = out + xp[:, j:j + S] * w[j]
    return out, xp[:, -(cw - 1):]


def _ssm_step(state, inputs, A):
    """state (B,Hs,P,N); inputs: x_t (B,Hs,P), dt (B,Hs), Bt/Ct (B,N)."""
    x_t, dt, Bt, Ct = inputs
    decay = torch.exp(dt * A)                                 # (B,Hs)
    upd = (dt[..., None] * x_t)[..., None] * Bt[:, None, None, :]
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Ct)
    return state, y


def ssm_apply_seq(cfg: ModelConfig, p, x, state, conv_state,
                  scan: Callable):
    """Full sequence (training, prefill) or one token (decode). x (B,S,d)
    -> y (B,S,d), new ssm state, new conv state. ``scan`` is K5's
    signature: (x, dt, a_log, b, c, d_skip, state) -> (y with the D skip,
    state)."""
    B, S, d = x.shape
    Hs, Ps = cfg.ssm_heads, cfg.ssm_head_dim
    xin = x @ p["in_proj"]
    xc, new_conv = causal_conv(xin, conv_state, p["conv_w"])
    b, h = local_layout(B, Hs)
    xc = maybe_shard(F.silu(xc), b, None, h).reshape(B, S, Hs, Ps)
    dt = F.softplus((x @ p["dt_proj"]) + p["dt_bias"]).float()
    Bt = (x @ p["b_proj"]).float()
    Ct = (x @ p["c_proj"]).float()
    # gradients: the per-head parameters see each data shard's batch, B
    # and C each model shard's heads (sums over those axes)
    bc_grad = P(b) if h is None else Reduced({"model": "sum"}, b)
    specs = (P(b, None, h, None), P(b, None, h), P(h), P(b), P(b), P(h),
             P(b, h))
    grads = specs[:2] + (summed_over(b, P(h)), bc_grad, bc_grad,
                         summed_over(b, P(h)), specs[-1])
    y, state = time_chunks(
        lambda x_, dt_, b_, c_, st: local_call(
            scan, (x_, dt_, p["a_log"], b_, c_, p["d_skip"], st), specs,
            (P(b, None, h, None), P(b, h)), grads),
        (xc, dt, Bt, Ct), state)
    y = y.to(x.dtype).reshape(B, S, Hs * Ps)
    return y @ p["out_proj"], state, new_conv


def ssm_apply_decode(cfg: ModelConfig, p, x, state, conv_state,
                     scan: Callable):
    """Single-token decode. x (B,1,d)."""
    return ssm_apply_seq(cfg, p, x, state, conv_state, scan)


def ssm_state_shapes(cfg: ModelConfig, batch: int):
    Hs, Ps, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "ssm_state": ((batch, Hs, Ps, N), torch.float32),
        "conv_state": ((batch, cfg.conv_width - 1, Hs * Ps),
                       cfg.compute_dtype),
    }
