"""Shared model machinery: parameter tables, norms, RoPE, initializers,
the training loss and activation recomputation.

A model is described by a *parameter table*: a nested dict of ``ParamDef``
(the layout of ``repro.models.common``). One table drives three views:
  - ``abstract_params``  -> meta tensors (dry-run, no allocation)
  - ``init_params``      -> parameters drawn from a ``torch.Generator`` on
    the target device, with the reference's distributions; the numbers
    differ from ``jax.random``'s, so parity runs load the reference's own
    weights through ``repro_torch.bridge``
  - ``partition_specs``  -> ``P`` tree, divisibility-sanitized
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.utils import time_loops
from repro_torch.utils.shardctx import (P, _sanitize, mesh_axes,  # noqa: F401
                                        placements)


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    # logical spec entries: a mesh-axis name (or tuple of names) or None
    # per dim
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


def abstract_params(table, config) -> Dict:
    """Meta tensors of the parameters' shapes and dtypes: no storage."""
    out: Dict = {}
    for path, d in _leaves(table):
        _set(out, path, torch.empty(
            d.shape, dtype=getattr(torch, d.dtype or config.param_dtype),
            device="meta"))
    return out


def sanitize_spec(d: ParamDef, mesh) -> P:
    """Drop sharding on dims not divisible by the mesh axis size, as the
    reference does (jax rejects uneven shardings; DTensor would shard
    them unevenly)."""
    return _sanitize(d.shape, d.pspec, mesh)


def partition_specs(table, mesh) -> Dict:
    out: Dict = {}
    for path, d in _leaves(table):
        _set(out, path, sanitize_spec(d, mesh))
    return out


def batch_axes(mesh) -> Any:
    """Mesh axes used for the batch dim: ('pod','data') when multi-pod."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def batch_pspec(mesh, size: int, *trailing) -> P:
    axes = batch_axes(mesh)
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    first = axes if size % n == 0 else None
    return P(first, *trailing)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack(tree: Dict, n: int):
    """The ``n`` slices of a tree of stacked (leading dim ``n``) tensors,
    one tree each. Slices by ``unbind``, whose backward stacks the slices'
    gradients once, where ``t[i]`` would add a zero-padded full-size
    gradient per slice."""
    parts = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def tree_leaves(tree):
    """The tensor leaves of a nested dict in sorted-key order; a list
    holds its leaves in that order already (a tree's grads)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, list):
        for t in tree:
            yield from tree_leaves(t)
    else:
        yield tree


# --- numerics ---------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    # the reference's cast order: f32 statistics, cast back to x's dtype
    # *before* the weight multiply
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x, w, b, eps: float = 1e-5):
    # as rms_norm: f32 mean and (biased) variance, normalised and cast
    # back to x's dtype before the weight and bias
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


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


def cross_entropy(logits, labels, ignore: int = -1):
    """Mean CE over non-ignored positions, in float32, as
    ``repro.models.common.cross_entropy``. logits (..., V), labels (...)."""
    # as rows (N, V): DTensor gathers from vocab-sharded 2-D rows only
    logits = logits.float().reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().clamp_min(0)[:, None])
    mask = (labels != ignore).float()
    loss = (lse[:, None] - ll)[:, 0] * mask
    return loss.sum() / torch.clamp_min(mask.sum(), 1.0)


# --- activation recomputation -------------------------------------------------

def remat(fn, *args):
    """``fn(*args)``; while autograd records, its activations are dropped
    and recomputed in the backward, where the reference wraps the same
    computation in ``jax.checkpoint``."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


TIME_CHUNK = 64    # steps per recomputed chunk of a recurrent scan


def time_chunks(fn, seqs, carry):
    """``fn(*seqs, carry) -> (ys, carry)`` over the time axis (dim 1 of
    every tensor of ``seqs`` and of ``ys``). While autograd records and S
    is a multiple of TIME_CHUNK above it, the scan runs chunk by chunk,
    each chunk under ``remat``, as the reference's
    ``xlstm._chunked_time_scan`` and ``ssm.ssm_apply_seq`` do: the
    backward keeps a carry per chunk instead of per step. The same steps
    in the same order either way. Inside the dry-run's
    ``utils.time_loops.stand_in_time_loops`` the loops in ``fn`` are cut
    (a step without autograd; every chunk but the last but one)."""
    S = seqs[0].shape[1]
    if not (torch.is_grad_enabled() and S % TIME_CHUNK == 0
            and S > TIME_CHUNK):
        # the dry-run cuts the loops of a step without autograd
        return time_loops.run_cut(not torch.is_grad_enabled(), fn, *seqs,
                                  carry)
    ys = []
    n = S // TIME_CHUNK
    for i in range(n):
        # under autograd the dry-run cuts the loops of every chunk but the
        # last but one, in the forward and the recomputation
        chunk = functools.partial(time_loops.run_cut, i != n - 2, fn)
        t = i * TIME_CHUNK
        y, carry = remat(chunk, *[s[:, t:t + TIME_CHUNK] for s in seqs],
                         carry)
        ys.append(y)
    return torch.cat(ys, dim=1), carry
