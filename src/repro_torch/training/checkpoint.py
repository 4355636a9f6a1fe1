"""Tree checkpointing to .npz, in the reference's format (port of
``repro.training.checkpoint``).

A key is the leaf's path joined by ``::``: a dict key as it is, a
NamedTuple field as ``.name`` (what the reference's JAX keypaths print),
a sequence index as the number; ``__step__`` holds the step (int64).
So ``{"params": p, "opt": AdamWState}`` gives ``params::emb``,
``opt::.step``, ``opt::.m::layers::wq``, ... Float32 and integer leaves
are stored as themselves. numpy has no bfloat16, and the reference's
files store a bf16 leaf as 2-byte void records of its bits (``<V2``):
the port writes its bf16 leaves the same way and reads a leaf back by
its bits whenever the template leaf is bf16.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

SEP = "::"


def keyed_leaves(tree, prefix=()):
    """(key, tensor) pairs of a tree of dicts, NamedTuples, lists and
    tuples, keyed as in the file."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keyed_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from keyed_leaves(getattr(tree, f), prefix + ("." + f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from keyed_leaves(v, prefix + (str(i),))
    else:
        yield SEP.join(prefix), tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    if leaf.dtype == torch.bfloat16 and arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(leaf.dtype)
    return t.to(leaf.device)


def save(path: str, tree, step: int = 0) -> None:
    """Write ``tree`` to ``path`` atomically: a ``.tmp`` file, then
    ``os.replace``."""
    flat: Dict[str, np.ndarray] = {k: _to_numpy(t)
                                   for k, t in keyed_leaves(tree)}
    flat["__step__"] = np.asarray(step, dtype=np.int64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), values)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def restore(path: str, template) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (shapes must match):
    each leaf in the template leaf's dtype, on its device."""
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else 0
        leaves = []
        for key, leaf in keyed_leaves(template):
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint {path}: {key} has shape "
                                 f"{arr.shape}, the template "
                                 f"{tuple(leaf.shape)}")
            leaves.append(_from_numpy(arr, leaf))
    return _rebuild(template, iter(leaves)), step
