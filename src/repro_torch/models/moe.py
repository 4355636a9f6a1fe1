"""Mixture-of-Experts layer: top-k routing with sort-based dispatch (port
of ``repro.models.moe``).

Dispatch is capacity-bounded as in the reference: dropless while
T * k <= 4096 (decode, short prefill), otherwise the Switch capacity
bound, with the pairs over an expert's capacity dropped. The expert
products are batched matrix products over the (E, C, d) dispatch buffer,
as the reference's einsums are: the reference has no MoE kernel.

Under a mesh (``utils.shardctx.use_mesh``, DTensor parameters and
activations) the dispatch buffer is sharded on E over the ``model`` axis,
as in the reference. ``moe_apply_ep`` is the reference's expert-parallel
path: each ``model`` shard routes every token, keeps only the pairs routed
to its own experts and the partial outputs are summed, one all-reduce a
layer. Without a mesh it is ``moe_apply``.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef
from repro_torch.utils.shardctx import (P, Reduced, batch_axis,
                                        current_mesh, local_call, maybe_shard,
                                        mesh_axes, shard_map_compat)

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


def _route(cfg: ModelConfig, xf, router):
    """Top-k routing of the tokens ``xf`` (T, d): (probs, top_p, top_i,
    counts) with the top-k weights renormalised and counts (E,) int64."""
    E, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ router                      # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k)               # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_i.reshape(-1)
    # counts in integers, so that no float atomics make the aux loss
    # differ from run to run
    counts = torch.zeros(E, dtype=torch.int64, device=xf.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    return probs, top_p, top_i, counts


def _aux(cfg: ModelConfig, probs, counts, T: int):
    """Switch-style load-balance aux loss."""
    me = probs.mean(0)
    ce = counts.float() * (1.0 / (T * cfg.top_k))
    return cfg.n_experts * torch.sum(me * ce)


def _sort_pairs(cfg: ModelConfig, top_p, top_i, counts):
    """The (token, slot) pairs sorted by expert: (order, se, st, sp,
    pos_in_e), pos_in_e the pair's position within its expert bucket."""
    T, k = top_i.shape
    dev = top_i.device
    flat_e = top_i.reshape(T * k)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_p = top_p.reshape(T * k)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sp = flat_e[order], flat_t[order], flat_p[order]
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - offsets[se]
    return order, se, st, sp, pos_in_e


def moe_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_load_balance_loss). p holds per-layer slices
    (router (d, E) float32, we1 (E, d, f), ...).

    Under a mesh the routing, the sort and the scatter into the dispatch
    buffer, and the combine after the experts, run on replicated copies
    (``local_call``): GSPMD replicates that buffer too (the reference's
    ``moe.py:97-98``), and DTensor has no sharding rule for a stable sort
    or for index writes. The buffer and the expert products are sharded
    on E over ``model`` (``maybe_shard``)."""
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    C = capacity(cfg, T)

    def dispatch(x, router):
        xf = x.reshape(T, d)
        probs, top_p, top_i, counts = _route(cfg, xf, router)
        aux = _aux(cfg, probs, counts, T)
        order, se, st, sp, pos_in_e = _sort_pairs(cfg, top_p, top_i,
                                                  counts)
        keep = pos_in_e < C
        dest = torch.where(keep, se * C + pos_in_e,
                           torch.full_like(se, E * C))  # E*C = drop slot
        buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
        buf[dest] = xf[st]
        return (buf[:E * C].reshape(E, C, d), aux, order, dest,
                (sp * keep).to(x.dtype))

    buf, aux, order, dest, w = local_call(dispatch, (x, p["router"]),
                                          (P(), P()), (P(),) * 5)
    buf = maybe_shard(buf, "model")
    h = F.silu(torch.bmm(buf, p["we1"])) * torch.bmm(buf, p["we3"])
    out_e = torch.bmm(h, p["we2"])
    out_e = maybe_shard(out_e, "model")

    def combine(out_e, order, dest, w):
        flat_out = torch.cat([out_e.reshape(E * C, d),
                              torch.zeros((1, d), dtype=out_e.dtype,
                                          device=out_e.device)])
        y_sorted = flat_out[dest] * w[:, None]
        return combine_sorted(y_sorted, order, cfg.top_k).reshape(B, S, d)

    y = local_call(combine, (out_e, order, dest, w), (P(),) * 4, P())
    return y, aux


# --- expert-parallel path (the reference's shard_map, here local_map) -------
#
# The sort+scatter dispatch of ``moe_apply`` is replicated on every shard.
# The expert-parallel version keeps activations replicated across the
# ``model`` axis, lets every expert shard scatter ONLY the tokens routed to
# its own experts, and combines partial outputs with one all-reduce per
# layer -- expert parallelism without an all-to-all, with the same routing
# math as ``moe_apply``.

def _local_moe(cfg: ModelConfig, x_l, router, we1, we3, we2, E_l: int,
               my0: int, repl: bool = False):
    """Per-shard expert computation on shard ``my0 // E_l`` of the
    ``model`` axis. ``repl=False``: weights arrive sharded on E (E
    divisible by the axis). ``repl=True`` (E NOT divisible -- e.g.
    granite's 40 experts on a 16-way axis): weights arrive replicated and
    each shard slices its ceil(E/n) window, clamped into [0, E); ownership
    is masked exactly, so trailing shards idle rather than double-count.
    Returns this shard's partial y (summed over ``model`` by the caller)
    and its aux loss (averaged over every shard by the caller)."""
    B_l, S, d = x_l.shape
    E = cfg.n_experts
    T = B_l * S
    xf = x_l.reshape(T, d)
    probs, top_p, top_i, counts = _route(cfg, xf, router)
    aux = _aux(cfg, probs, counts, T)
    order, se, st, sp, pos_in_e = _sort_pairs(cfg, top_p, top_i, counts)

    C = capacity(cfg, T)
    if repl:
        # clamped slice window; ownership mask stays exact
        start = min(my0, max(E - E_l, 0))
        we1, we3, we2 = (w[start:start + E_l] for w in (we1, we3, we2))
    else:
        start = my0
    mine = (se >= my0) & (se < my0 + E_l) & (se < E)
    keep = (pos_in_e < C) & mine
    dest = torch.where(keep, (se - start) * C + pos_in_e,
                       torch.full_like(se, E_l * C))

    buf = torch.zeros((E_l * C + 1, d), dtype=x_l.dtype, device=x_l.device)
    buf[dest] = torch.where(keep[:, None], xf[st], 0)
    buf = buf[:E_l * C].reshape(E_l, C, d)
    h = F.silu(torch.bmm(buf, we1)) * torch.bmm(buf, we3)
    out_e = torch.bmm(h, we2)
    flat_out = torch.cat([out_e.reshape(E_l * C, d),
                          torch.zeros((1, d), dtype=x_l.dtype,
                                      device=x_l.device)])
    y_sorted = flat_out[dest] * (sp * keep).to(x_l.dtype)[:, None]
    y = combine_sorted(y_sorted, order, cfg.top_k)
    return y.reshape(B_l, S, d), aux


def moe_apply_ep(cfg: ModelConfig, p, x):
    """Expert-parallel MoE over the ``model`` axis. Falls back to
    ``moe_apply`` when no mesh is installed or ``x`` is not a DTensor.
    ``REPRO_MOE_EP=0`` forces the replicated-dispatch baseline
    (paper-faithful §Perf baseline runs)."""
    mesh = current_mesh()
    if os.environ.get("REPRO_MOE_EP", "1") == "0" or mesh is None \
            or "model" not in mesh_axes(mesh) or not isinstance(x, DTensor):
        return moe_apply(cfg, p, x)
    sizes = mesh_axes(mesh)
    n_model = sizes["model"]
    repl = bool(cfg.n_experts % n_model)
    E_l = -(-cfg.n_experts // n_model)  # ceil: last shards may idle (H8)
    dp = batch_axis()
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    b = dp if x.shape[0] % n_dp == 0 else None
    # indivisible E: weights replicated into each shard (small-expert
    # archs only; divisible E keeps weights sharded on E)
    w_spec = P() if repl else P("model", None, None)
    my0 = mesh.get_local_rank("model") * E_l
    n_all = math.prod(sizes.values())

    def local(x_l, router, we1, we3, we2):
        y, aux = _local_moe(cfg, x_l, router, we1, we3, we2, E_l, my0,
                            repl=repl)
        # aux: the mean over every shard (the reference's pmean over
        # ``model`` and the data axes) as a sum of n_all parts; a summed
        # partial gives each part its gradient, an averaged one does not
        return y, aux / n_all

    # y: partial sums over ``model`` (the reference's psum). A batch
    # replicated over the data axes gives equal y on each data shard,
    # which stays replicated there (the reference's pmean of equal
    # values). Gradients: each model shard's partial y reaches x and the
    # router through its own experts only (summed over ``model``), each
    # data shard's batch reaches every replicated weight (summed over the
    # data axes): the sums JAX's shard_map transpose makes.
    data_sum = {a: "sum" for a in dp} if b is not None else {}
    w_grad = Reduced(dict(data_sum, **({"model": "sum"} if repl else {})),
                     *w_spec)
    fn = shard_map_compat(
        local, mesh,
        in_specs=(P(b, None, None), P(), w_spec, w_spec, w_spec),
        out_specs=(Reduced({"model": "sum"}, b, None, None),
                   Reduced({a: "sum" for a in sizes})),
        in_grad_specs=(Reduced({"model": "sum"}, b, None, None),
                       Reduced(dict(data_sum, model="sum")),
                       w_grad, w_grad, w_grad),
    )
    y, aux = fn(x, p["router"], p["we1"], p["we3"], p["we2"])
    return maybe_shard(y, batch_axis()), aux


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
