"""Mesh context for intra-model sharding constraints (port of
``repro.utils.shardctx``).

Model code calls ``maybe_shard(x, spec_entries...)``; when a mesh has been
installed (``use_mesh``) and ``x`` is a ``DTensor`` this becomes a
``DTensor.redistribute`` to the divisibility-sanitized entries, otherwise
it is a no-op (the single-card paths hold plain tensors and no mesh).

A spec is a ``P``: one entry per tensor dim, each a mesh axis name, a
tuple of names or ``None``, as the reference's ``PartitionSpec``.
``placements(spec, mesh)`` turns it into DTensor placements: ``Shard(d)``
on each mesh dim that names tensor dim ``d``, ``Replicate()`` on the
others. A mesh is read only by its axis names and sizes (``mesh_axes``),
so a stand-in whose ``.shape`` is a dict of them serves the spec
functions.
"""
from __future__ import annotations

import contextlib
import types
from typing import Dict, List

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import (implicit_replication,
                                                    local_map)

# process-wide, not thread-local as the reference's: autograd runs a CUDA
# backward, and with it the recompute of each checkpointed block, on its
# own device thread, which must see the mesh the forward saw
_state = types.SimpleNamespace(mesh=None)


class P(tuple):
    """A partition spec: ``P("data", None, "model")``; a one-name tuple
    entry is that name, as jax's PartitionSpec keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def current_mesh():
    return _state.mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` for ``maybe_shard`` and friends. Plain tensors
    that meet a DTensor inside are taken as replicated, as unsharded
    arrays are under the reference's mesh."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _state.mesh = prev


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}: a DeviceMesh's dim names and sizes, or a
    stand-in's ``.shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _sanitize(shape, entries, mesh) -> P:
    sizes = mesh_axes(mesh)
    out = []
    for size, ax in zip(shape, entries):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if not all(a in sizes for a in axes):
            out.append(None)
            continue
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(ax if size % n == 0 else None)
    return P(*out)


def placements(spec, mesh, partial=None) -> List:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where entry ``d`` names the mesh dim; else, where
    ``partial`` ({axis name: "sum" or "avg"}) names the mesh dim,
    ``Partial`` (a local result still to be reduced over it); else
    ``Replicate()``. A dim sharded over two mesh axes, as
    ``("pod", "data")``, is split by the first one outermost."""
    partial = partial or {}
    out = []
    for name in mesh.mesh_dim_names:
        pl = Partial(partial[name]) if name in partial else Replicate()
        for d, ax in enumerate(spec):
            if ax is not None and name in (ax if isinstance(ax, tuple)
                                           else (ax,)):
                pl = Shard(d)
        out.append(pl)
    return out


def maybe_shard(x, *entries):
    """Redistribute a DTensor ``x`` to the sanitized entries if a mesh is
    installed; ``x`` unchanged otherwise."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    entries = entries + (None,) * (x.ndim - len(entries))
    return x.redistribute(mesh, placements(_sanitize(x.shape, entries, mesh),
                                           mesh))


def constrain(x, spec):
    """``x`` in the layout of ``spec`` (already sanitized, as the ZeRO
    specs are) on its own mesh, if it is a DTensor: the reference's
    ``with_sharding_constraint`` with a given sharding. A nested dict
    takes a tree of specs of its structure."""
    if isinstance(x, dict):
        return {k: constrain(v, spec[k]) for k, v in x.items()}
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


class Reduced(P):
    """An output spec whose mesh axes in ``ops`` ({axis name: "sum" or
    "avg"}) hold partial results still to be reduced: the reference's
    ``psum`` / ``pmean`` inside a ``shard_map``, here done by the
    redistribute that next reads the output."""

    def __new__(cls, ops, *entries):
        self = super().__new__(cls, *entries)
        self.ops = dict(ops)
        return self


def shard_map_compat(f, mesh, in_specs, out_specs, in_grad_specs=None):
    """The reference's ``shard_map`` as ``local_map``: ``f`` runs on the
    local shards of its DTensor arguments, redistributed first to
    ``in_specs`` (one ``P`` per argument, ``None`` for one that is not a
    tensor), and its outputs become DTensors of ``out_specs`` (a ``P`` or
    ``Reduced``, or a tuple of them for a tuple of outputs). With no
    DTensor among the arguments, ``f`` runs on them as they are.

    ``in_grad_specs`` (as ``in_specs``) says where each argument's
    gradient lands: an argument replicated over an axis whose shards
    compute different parts (a weight under a batch split over ``data``)
    gets a ``Reduced`` spec there, the sum JAX's shard_map transpose
    makes."""
    def pl(spec):
        if isinstance(spec, Reduced):
            return placements(spec, mesh, spec.ops)
        return placements(spec, mesh)

    in_pl = tuple(None if s is None else pl(s) for s in in_specs)
    out_pl = pl(out_specs) if isinstance(out_specs, P) \
        else tuple(pl(s) for s in out_specs)
    grad_pl = None if in_grad_specs is None else tuple(
        None if s is None else pl(s) for s in in_grad_specs)
    mapped = local_map(f, out_placements=out_pl, in_placements=in_pl,
                       in_grad_placements=grad_pl, device_mesh=mesh,
                       redistribute_inputs=True)

    def call(*args):
        if not any(isinstance(a, DTensor) for a in args):
            return f(*args)
        return mapped(*args)
    return call


def local_layout(B: int, n_heads: int):
    """(batch entry, head entry) of a local computation's layout under
    the installed mesh: the batch over the data axes, heads over
    ``model``, each None where it does not divide (or no mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return None, None
    return tuple(_sanitize((B, n_heads), (batch_axis(), "model"), mesh))


def local_call(fn, args, specs, out_spec, grad_specs=None):
    """``fn(*args)``, on the local shards (``shard_map_compat``) when a
    mesh is installed and an argument is a DTensor."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*args)
    return shard_map_compat(fn, mesh, specs, out_spec,
                            in_grad_specs=grad_specs)(*args)


def summed_over(b, spec=P()):
    """The gradient spec of an argument replicated over the data axes of
    batch entry ``b`` while the batch is split over them: ``spec`` with
    its local gradients summed over those axes (``spec`` as it is when
    the batch is not split)."""
    if b is None:
        return spec
    axes = b if isinstance(b, tuple) else (b,)
    return Reduced({a: "sum" for a in axes}, *spec)


def batch_local(fn, params, acts, n_out: int):
    """``fn(params, *acts)`` -> ``n_out`` tensors (one tensor if 1). Under
    a mesh it runs on the local batch shard: the ``params`` dict's tensors
    replicated (their gradients summed over the data axes), the ``acts``
    and the outputs split by batch (dim 0) over the data axes."""
    if current_mesh() is None:
        return fn(params, *acts)
    names = sorted(params)
    b, _ = local_layout(acts[0].shape[0], 1)

    def local(*flat):
        return fn(dict(zip(names, flat)), *flat[len(names):])

    specs = (P(),) * len(names) + (P(b),) * len(acts)
    grads = (summed_over(b),) * len(names) + (P(b),) * len(acts)
    out = P(b) if n_out == 1 else (P(b),) * n_out
    return local_call(local, (*(params[n] for n in names), *acts), specs,
                      out, grads)


def zeros(shape, dtype, device, spec=()):
    """Zeros on ``device``, or a DTensor of ``spec`` (its shards only)
    when ``device`` is a DeviceMesh."""
    if isinstance(device, DeviceMesh):
        return dtensor_zeros(shape, dtype=dtype, device_mesh=device,
                             placements=placements(spec, device))
    return torch.zeros(shape, dtype=dtype, device=device)


def home(x):
    """Where a tensor like ``x`` is made: its DeviceMesh if it is a
    DTensor, else its device."""
    return x.device_mesh if isinstance(x, DTensor) else x.device


def distribute(tree, specs, mesh):
    """Every tensor of a nested dict as a DTensor of its spec (``specs``
    the same tree of ``P``) on ``mesh``. Each rank must hold the whole
    tensor and keeps its own shards: no communication."""
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements(specs, mesh),
                             src_data_rank=None)


def batch_axis():
    """Logical batch axes for the current mesh ('pod','data') or ('data',)."""
    mesh = current_mesh()
    if mesh is not None and "pod" in mesh_axes(mesh):
        return ("pod", "data")
    return ("data",)
