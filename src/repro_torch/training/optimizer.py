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

from repro_torch.models.common import tree_leaves, tree_map


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
    """Step 0 and zero float32 moments, on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
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
    ``tree_leaves`` order. ``shardings``
    (the reference's ZeRO-1 layouts) needs a device mesh: ROADMAP.md
    item 18."""
    if shardings is not None:
        raise ValueError("adamw_update: shardings need a device mesh, not "
                         "ported yet (ROADMAP.md section 1, item 18)")
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    step = state.step + 1
    b1, b2 = cfg.betas
    lr = lr_schedule(step, cfg)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        u.add_(cfg.weight_decay * p32)
        p.copy_((p32 - lr * u).to(p.dtype))
    return params, AdamWState(step, state.m, state.v), \
        {"lr": lr, "grad_norm": gn}
