"""Mixture-of-Experts layer: top-k routing with sort-based dispatch (port
of ``repro.models.moe``).

Dispatch is capacity-bounded as in the reference: dropless while
T * k <= 4096 (decode, short prefill), otherwise the Switch capacity
bound, with the pairs over an expert's capacity dropped. The expert
products are batched matrix products over the (E, C, d) dispatch buffer,
as the reference's einsums are: the reference has no MoE kernel.

One card holds every expert, so only ``moe_apply`` is ported: the
reference's expert-parallel ``moe_apply_ep`` (and its per-shard
``_local_moe``) falls back to ``moe_apply`` when no mesh is installed,
and the mesh belongs to ROADMAP.md item 18.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef

DROPLESS_PAIRS = 4096    # up to this many (token, slot) pairs: no capacity


def moe_param_table(cfg: ModelConfig, L: int) -> Dict[str, ParamDef]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((L, d, E), (None, None, None), dtype="float32"),
        "we1": ParamDef((L, E, d, f), (None, "model", None, None)),
        "we3": ParamDef((L, E, d, f), (None, "model", None, None)),
        "we2": ParamDef((L, E, f, d), (None, "model", None, None)),
    }


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: T * k (dropless) up to
    ``DROPLESS_PAIRS`` pairs, else the Switch bound (``moe.py:73-76``)."""
    k = cfg.top_k
    if T * k <= DROPLESS_PAIRS:
        return T * k
    return int(max(k, -(-T * k // cfg.n_experts) * cfg.capacity_factor))


def moe_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_load_balance_loss). p holds per-layer slices
    (router (d, E) float32, we1 (E, d, f), ...)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xf = x.reshape(T, d)

    logits = xf.float() @ p["router"]                 # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k)               # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance aux loss; counts in integers, so that no
    # float atomics make it differ from run to run
    flat_e = top_i.reshape(T * k)
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    me = probs.mean(0)
    ce = counts.float() * (1.0 / (T * k))
    aux = E * torch.sum(me * ce)

    # flatten (token, slot) pairs and sort by expert
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_p = top_p.reshape(T * k)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sp = flat_e[order], flat_t[order], flat_p[order]

    # position of each entry within its expert bucket
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - offsets[se]

    C = capacity(cfg, T)
    keep = pos_in_e < C
    dest = torch.where(keep, se * C + pos_in_e,
                       torch.full_like(se, E * C))      # E*C = drop slot

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = xf[st]
    buf = buf[:E * C].reshape(E, C, d)

    h = F.silu(torch.bmm(buf, p["we1"])) * torch.bmm(buf, p["we3"])
    out_e = torch.bmm(h, p["we2"])

    flat_out = torch.cat([out_e.reshape(E * C, d),
                          torch.zeros((1, d), dtype=x.dtype, device=dev)])
    y_sorted = flat_out[dest] * (sp * keep).to(x.dtype)[:, None]
    y = combine_sorted(y_sorted, order, k)
    return y.reshape(B, S, d), aux


def combine_sorted(y_sorted, order, k: int):
    """Each token's sum of its k rows of ``y_sorted`` (the (token, slot)
    pairs in expert order: row j is pair ``order[j]`` = token * k + slot).

    The reference scatter-adds ``y_sorted`` into zeros, which adds each
    token's k contributions in sorted (ascending expert) order, rounded to
    the dtype after each add. ``index_add_`` on CUDA adds in the order its
    atomics land, so its bf16 rounding changes from run to run. Here each
    token's k rows are found in sorted order and added in that order:
    the reference's rounding, and the same bits on every run."""
    Tk, d = y_sorted.shape
    inv = torch.empty_like(order)
    inv[order] = torch.arange(Tk, device=order.device)
    mine = torch.sort(inv.reshape(Tk // k, k), dim=1).values
    y = torch.zeros((Tk // k, d), dtype=y_sorted.dtype,
                    device=y_sorted.device)
    for j in range(k):
        y = y + y_sorted[mine[:, j]]
    return y
