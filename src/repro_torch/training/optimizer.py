"""AdamW + cosine schedule with warmup (port of
``repro.training.optimizer``).

The update is the reference's, written out: the grads clipped by their
global norm before the moments, m and v in float32 whatever the
parameter dtype, bias correction with the step as float32, weight decay
inside the update, and the update taken in float32 and cast back to the
parameter dtype (no master weights). ``torch.optim.AdamW`` differs on
each of these points, so it is not used.

The update runs in place under ``torch.no_grad()``: the parameters, m
and v are updated where they lie, and the returned trees are the same
tensors. At full width a functional update would hold a second copy of
m and v (16 GB at qwen3-1.7b).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.utils.shardctx import constrain


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: Any               # float32 tree shaped as the params
    v: Any


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    """Step 0 and zero float32 moments, on the parameters' device (in
    their layout, for DTensor parameters)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = next(tree_leaves(params)).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def lr_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to 0.1 * lr at
    ``total_steps``; float32 arithmetic, as the reference's."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 shardings=None):
    """Returns (params, new_state, metrics), ``params`` and the state's m
    and v updated in place (see the module's docstring). ``grads`` is a
    tree shaped as ``params`` or the list of its leaves in
    ``tree_leaves`` order.

    ``shardings`` (optional tree of ``P``, the ZeRO-1 specs of
    ``launch.specs.zero1_shardings``) pins the whole elementwise update of
    DTensor parameters to the sharded layout, so the gathered float32 m
    and v never exist: the clipped grads, the parameters (a slice, no
    communication) and m and v are taken to it, and only the updated
    parameters go back to their tensor-parallel layout (§Perf H6). m and
    v are updated where they lie when they are in that layout already
    (``abstract_opt_state``, or a second step); else the state returned
    holds them in it."""
    specs = [None] * len(list(tree_leaves(params))) if shardings is None \
        else list(tree_leaves(shardings))

    def pin(x, spec):
        return x if spec is None else constrain(x, spec)

    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    step = state.step + 1
    b1, b2 = cfg.betas
    lr = lr_schedule(step, cfg)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    ms = [pin(m, s) for m, s in zip(tree_leaves(state.m), specs)]
    vs = [pin(v, s) for v, s in zip(tree_leaves(state.v), specs)]
    for p, g, m, v, s in zip(tree_leaves(params), tree_leaves(grads), ms,
                             vs, specs):
        g = pin(g.float() * scale, s)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = pin(p, s).float()   # refine to the z1 layout: slice, no comm
        u.add_(cfg.weight_decay * p32)
        new = (p32 - lr * u).to(p.dtype)
        if isinstance(new, DTensor):
            # back to the tensor-parallel layout: the one all-gather
            new = new.redistribute(p.device_mesh, p.placements)
        p.copy_(new)
    if shardings is not None:
        state = AdamWState(state.step, _rebuild(state.m, iter(ms)),
                           _rebuild(state.v, iter(vs)))
    return params, AdamWState(step, state.m, state.v), \
        {"lr": lr, "grad_norm": gn}


def _rebuild(tree, leaves):
    """``tree``'s structure with the next of ``leaves`` at each leaf, in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)
