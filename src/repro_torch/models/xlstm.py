"""xLSTM: alternating mLSTM (matrix memory) and sLSTM (scalar memory)
blocks (port of ``repro.models.xlstm``).

24 layers are organized as 12 pair-blocks (mLSTM -> sLSTM) with their
parameters stacked on a leading P dim, as in the reference. Exponential
gating with the log-space max-stabilizer from arXiv:2405.04517.

The mLSTM recurrence runs through a ``ScanOps``: ``KERNEL_SCAN_OPS``
(the default) sends it to the mLSTM scan kernel (K4), whose wrapper runs
its plain version on a CPU tensor; ``PLAIN_SCAN_OPS`` runs the plain
version on any device, as the yardstick the kernel is held against. The
sLSTM recurrence has no kernel in the reference (a jnp scan there): it is
a PyTorch loop over time here, with float32 carries. Training runs
``PLAIN_SCAN_OPS`` (the kernel is forward-only); while autograd records,
both recurrences run in chunks recomputed in the backward
(``common.time_chunks``), the reference's ``_chunked_time_scan``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.models.common import ParamDef, rms_norm, time_chunks
from repro_torch.utils import time_loops


@dataclass(frozen=True)
class ScanOps:
    mlstm: Callable     # (q, k, v, ig, fg, (C, n, m)) -> (h, (C, n, m))


KERNEL_SCAN_OPS = ScanOps(mlstm_ops.mlstm_scan)
PLAIN_SCAN_OPS = ScanOps(mlstm_ops.mlstm_scan_plain)


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    dm = int(cfg.mlstm_proj_factor * d)        # mLSTM inner
    H = cfg.n_heads
    dh = dm // H
    dsf = int(cfg.slstm_proj_factor * d)       # sLSTM ffn inner
    return d, dm, H, dh, dsf


def xlstm_param_table(cfg: ModelConfig) -> Dict:
    d, dm, H, dh, dsf = _dims(cfg)
    P = int(cfg.n_layers // 2)  # pair blocks
    mk = lambda *s: ParamDef(s, (None,) * len(s))
    col = lambda *s: ParamDef(s, (None,) * (len(s) - 1) + ("model",))
    return {
        "emb": ParamDef((cfg.vocab_size, d), ("model", None)),
        "final_norm": ParamDef((d,), (None,), init="ones"),
        "lm_head": ParamDef((d, cfg.vocab_size), (None, "model")),
        "pairs": {
            # mLSTM half
            "m_norm": ParamDef((P, d), (None, None), init="ones"),
            "m_up": col(P, d, 2 * dm),
            "m_q": col(P, dm, dm),
            "m_k": col(P, dm, dm),
            "m_v": col(P, dm, dm),
            "m_ig": mk(P, dm, H),
            "m_fg": mk(P, dm, H),
            "m_out_norm": ParamDef((P, dm), (None, None), init="ones"),
            "m_down": ParamDef((P, dm, d), (None, "model", None)),
            # sLSTM half
            "s_norm": ParamDef((P, d), (None, None), init="ones"),
            "s_w": col(P, d, 4 * d),
            "s_r": mk(P, d, 4 * d),
            "s_up1": col(P, d, dsf),
            "s_up2": col(P, d, dsf),
            "s_down": ParamDef((P, dsf, d), (None, "model", None)),
        },
    }


# --- mLSTM ------------------------------------------------------------------

def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the reference multiplies a bf16
    array by a Python float in bf16 (a weak-typed scalar), where PyTorch
    would multiply by the unrounded float."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def mlstm_apply(cfg: ModelConfig, p, x, state, ops: ScanOps = KERNEL_SCAN_OPS):
    """x (B,S,d); state {C, n, m}. Returns (y, new_state)."""
    d, dm, H, dh, _ = _dims(cfg)
    B, S, _ = x.shape
    xn = rms_norm(x, p["m_norm"])
    inner = xn @ p["m_up"]
    xm, z = torch.chunk(inner, 2, dim=-1)
    scale = _in_dtype(dh ** -0.5, x.dtype)
    # q and k scaled in the activation dtype, then cast to f32
    q = ((xm @ p["m_q"]).reshape(B, S, H, dh) * scale).float()
    k = ((xm @ p["m_k"]).reshape(B, S, H, dh) * scale).float()
    v = (xm @ p["m_v"]).reshape(B, S, H, dh).float()
    ig = (xm @ p["m_ig"]).float()
    fg = (xm @ p["m_fg"]).float()
    h, (C, n, m) = time_chunks(ops.mlstm, (q, k, v, ig, fg),
                               (state["C"], state["n"], state["m"]))
    h = h.reshape(B, S, dm).to(x.dtype)
    h = rms_norm(h, p["m_out_norm"]) * F.silu(z)
    return x + h @ p["m_down"], {"C": C, "n": n, "m": m}


def mlstm_state(cfg: ModelConfig, batch: int):
    _, dm, H, dh, _ = _dims(cfg)
    z = lambda *s: ((batch,) + s, torch.float32)
    return {"C": z(H, dh, dh), "n": z(H, dh), "m": z(H)}


# --- sLSTM ------------------------------------------------------------------

def _slstm_scan(pre, r, carry):
    """The sLSTM recurrence over pre (B,S,4d) from carry (c, n, m, h);
    returns (h (B,S,d), carry)."""
    c, n, m, h = carry
    hs = []
    S = pre.shape[1]
    for t in time_loops.steps(S):
        gates = pre[:, t] + h @ r
        i, f, zg, o = torch.chunk(gates, 4, dim=-1)
        logf = F.logsigmoid(f)
        m_new = torch.maximum(logf + m, i)
        i_p = torch.exp(i - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * torch.tanh(zg)
        n = f_p * n + i_p
        h = torch.sigmoid(o) * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
        if t == 0:
            hs += time_loops.kept_outputs(h, S)
    return torch.stack(hs, dim=1), (c, n, m, h)


def slstm_apply(cfg: ModelConfig, p, x, state):
    """x (B,S,d); state {c, n, m, h} (B,d) f32. Returns (y, new_state)."""
    xn = rms_norm(x, p["s_norm"])
    pre = (xn @ p["s_w"]).float()                    # (B,S,4d)
    r = p["s_r"].float()
    hs, carry = time_chunks(lambda pre_, c: _slstm_scan(pre_, r, c), (pre,),
                            tuple(state[k] for k in ("c", "n", "m", "h")))
    state = dict(zip(("c", "n", "m", "h"), carry))
    x = x + hs.to(x.dtype)
    # gated ffn (proj factor 4/3); jax.nn.gelu is the tanh approximation
    y = F.gelu((x @ p["s_up1"]).float(), approximate="tanh").to(x.dtype) \
        * (x @ p["s_up2"])
    return x + y @ p["s_down"], state


def slstm_state(cfg: ModelConfig, batch: int):
    d = cfg.d_model
    return {k: ((batch, d), torch.float32) for k in ("c", "n", "m", "h")}


# --- pair block ---------------------------------------------------------------

def pair_apply(cfg: ModelConfig, p_pair, x, pair_state,
               ops: ScanOps = KERNEL_SCAN_OPS):
    x, m_state = mlstm_apply(cfg, p_pair, x, pair_state["m"], ops)
    x, s_state = slstm_apply(cfg, p_pair, x, pair_state["s"])
    return x, {"m": m_state, "s": s_state}


def pair_state_shapes(cfg: ModelConfig, batch: int):
    return {"m": mlstm_state(cfg, batch), "s": slstm_state(cfg, batch)}
