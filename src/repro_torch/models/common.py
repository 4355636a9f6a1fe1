"""Shared model machinery: parameter tables, norms, RoPE, initializers.

A model is described by a *parameter table*: a nested dict of ``ParamDef``
(the layout of ``repro.models.common``). ``init_params`` draws the
parameters from a ``torch.Generator`` on the target device, with the
reference's distributions; the numbers differ from ``jax.random``'s, so
parity runs load the reference's own weights through ``repro_torch.bridge``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    # logical spec entries of the reference (mesh-axis name or None per
    # dim); kept so the tables read the same, unused on one device
    pspec: Tuple[Any, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)
    dtype: Optional[str] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.pspec), (self.shape, self.pspec)


def _leaves(table, prefix=()):
    """(path, ParamDef) pairs in the reference's pytree order (sorted
    dict keys)."""
    for k in sorted(table):
        v = table[k]
        if isinstance(v, ParamDef):
            yield prefix + (k,), v
        else:
            yield from _leaves(v, prefix + (k,))


def _set(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_params(table, config, generator: torch.Generator,
                device) -> Dict:
    """Initialized parameters on ``device``, drawn from ``generator``
    (which must live on the same device): ones / zeros, or
    N(0, 1) * scale in float32 cast to the parameter dtype, with
    ``scale = 1/sqrt(fan_in)`` unless the table sets it."""
    out: Dict = {}
    for path, d in _leaves(table):
        dt = getattr(torch, d.dtype or config.param_dtype)
        if d.init == "zeros":
            x = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init == "ones":
            x = torch.ones(d.shape, dtype=dt, device=device)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = d.scale if d.scale is not None else fan_in ** -0.5
            x = (torch.randn(d.shape, generator=generator,
                             dtype=torch.float32, device=device)
                 * scale).to(dt)
        _set(out, path, x)
    return out


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


# --- numerics ---------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    # the reference's cast order: f32 statistics, cast back to x's dtype
    # *before* the weight multiply
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x, positions, theta: float, partial: bool = False):
    """Rotary embedding. x: (..., S, H, dh); positions: (S,) or (B, S).

    ``partial`` (chatglm rope-2d): rotate only the first half of head_dim.
    Angles are float32; the rotated halves are float32 products cast back
    to x's dtype, as in ``repro.models.common.rope``.
    """
    dh = x.shape[-1]
    rot = dh // 2 if partial else dh
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over head axis
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                  dim=-1).to(x.dtype)
    return torch.cat([y, x_pass], dim=-1) if partial else y
