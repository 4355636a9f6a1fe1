"""Abstract input specs + shardings for every (arch x input-shape x mesh)
(port of ``repro.launch.specs``).

The spec functions return ``P`` trees (the reference's PartitionSpecs,
entry for entry) and read the mesh only by its axis names and sizes.
``lowering_specs(arch, shape, mesh)`` lists a step's arguments as
(shape, dtype) trees with their specs, allocating nothing;
``argument_bytes`` sums their local shards. ``build_lowering(arch,
shape, mesh)`` returns (step, args, placements, meta): ``args`` are
DTensors of fake tensors (``FakeTensorMode``, ``meta["fake_mode"]``) on a
DeviceMesh, so ``step(*args)`` runs under that mode with no device memory
-- the torch counterpart of ``jax.jit(...).lower`` on
ShapeDtypeStructs. The step runs the kernels' plain versions
(``HOST_OPS``): fake tensors live on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import build_model, decode_cache_plan
from repro_torch.models import transformer, xlstm
from repro_torch.models.common import batch_axes
from repro_torch.shapes import get_shape
from repro_torch.training.optimizer import AdamWConfig, AdamWState
from repro_torch.training.trainer import make_train_step
from repro_torch.utils.shardctx import P, _sanitize, mesh_axes, placements


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _sanitized(mesh, shape: Tuple[int, ...], entries) -> P:
    entries = tuple(entries) + (None,) * (len(shape) - len(entries))
    return _sanitize(shape, entries, mesh)


def batch_shardings(mesh, batch_abs: Dict[str, Tuple]) -> Dict[str, P]:
    """``batch_abs``: {name: (shape, dtype)}, as ``Model.batch_shapes``."""
    ba = batch_axes(mesh)
    return {k: _sanitized(mesh, s, (ba,)) for k, (s, _) in batch_abs.items()}


def cache_shardings(mesh, cache_abs):
    """Baseline cache sharding: (L, B, S, ...) -> batch over data axes,
    cache length over the model axis where divisible (flash-decoding-
    style length parallelism), else replicated. ``cache_abs``: a tree of
    (shape, dtype), as ``Model.cache_shapes``. The decode step moves the
    cache to its local attention layout (slots on every shard) before
    the kernels read it: ``models.transformer.cache_layout``."""
    ba = batch_axes(mesh)

    def leaf(sd):
        shape = sd[0]
        if len(shape) >= 3:
            return _sanitized(mesh, shape, (None, ba, "model"))
        if len(shape) == 2:
            return _sanitized(mesh, shape, (None, ba))
        return P()

    return _map(leaf, cache_abs)


def params_shardings(mesh, model):
    return model.partition_specs(mesh)


def abstract_opt_state(params_abs) -> AdamWState:
    """Step and float32 m/v of ``params_abs`` (shape, dtype) leaves."""
    f32 = lambda sd: (tuple(sd[0]), torch.float32)
    return AdamWState(((), torch.int32), _map(f32, params_abs),
                      _map(f32, params_abs))


def zero1_shardings(mesh, model):
    """ZeRO-1 optimizer-state sharding: on top of each parameter's tensor-
    parallel spec, shard the largest still-replicated divisible dim over
    the data axes. Optimizer state is touched only inside the update, so
    the extra gather cost is one params-sized all-gather per step while
    the resident f32 m/v drop by the data-parallel factor (§Perf H2)."""
    ba = batch_axes(mesh)
    sizes = mesh_axes(mesh)
    n_data = 1
    for a in ba:
        n_data *= sizes[a]
    params_abs = model.abstract_params()
    pspecs = model.partition_specs(mesh)

    def leaf(x, spec):
        entries = list(spec) + [None] * (x.ndim - len(spec))
        best, best_size = -1, 0
        for i, (size, e) in enumerate(zip(x.shape, entries)):
            if e is None and size % n_data == 0 and size > best_size:
                best, best_size = i, size
        if best >= 0:
            entries[best] = ba if len(ba) > 1 else ba[0]
        return P(*entries)

    return _map(leaf, params_abs, pspecs)


def scan_trip_counts(cfg) -> int:
    """The reference's trip count for scaling while-body collectives in
    its HLO parse. The port's eager layer loop issues every layer's
    collectives itself, so its dry-run passes 1 to ``collective_bytes``
    and records this number beside it."""
    if cfg.family == "ssm":
        return cfg.n_layers // 2
    return max(cfg.n_layers, cfg.n_encoder_layers or 0)


def _config(arch_id: str, shape_name: str, kv_quant: bool):
    cfg = get_config(arch_id)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if shape_name == "long_500k" and not cfg.supports_long_context:
        raise ValueError(f"{arch_id} skips long_500k (DESIGN.md §4)")
    return cfg


def lowering_specs(arch_id: str, shape_name: str, mesh, zero1: bool = True,
                   kv_quant: bool = False):
    """(model, names, shapes, specs, meta): the step's arguments by name,
    each a tree of (shape, dtype) and a tree of ``P``, as the reference's
    ``build_lowering`` gives them (``pos`` a () int32)."""
    cfg = _config(arch_id, shape_name, kv_quant)
    shape = get_shape(shape_name)
    model = build_model(cfg)
    params_abs = _map(lambda t: (tuple(t.shape), t.dtype),
                      model.abstract_params())
    params_sh = params_shardings(mesh, model)
    batch_abs = model.batch_shapes(shape)
    batch_sh = batch_shardings(mesh, batch_abs)
    meta = {"arch": arch_id, "shape": shape_name, "cfg": cfg,
            "model": model, "kind": shape.kind}
    if shape.kind == "train":
        z1 = zero1_shardings(mesh, model)
        opt_abs = abstract_opt_state(params_abs)
        opt_sh = AdamWState(P(), z1, z1) if zero1 \
            else AdamWState(P(), params_sh, params_sh)
        meta["zero1"] = z1
        return (model, ("params", "opt_state", "batch"),
                (params_abs, opt_abs, batch_abs),
                (params_sh, opt_sh, batch_sh), meta)
    plan = decode_cache_plan(cfg, shape.seq_len)
    meta["plan"] = plan
    if shape.kind == "prefill":
        return (model, ("params", "batch"), (params_abs, batch_abs),
                (params_sh, batch_sh), meta)
    cache_abs = model.cache_shapes(shape.global_batch, plan)
    return (model, ("params", "cache", "tokens", "pos"),
            (params_abs, cache_abs, batch_abs["tokens"], ((), torch.int32)),
            (params_sh, cache_shardings(mesh, cache_abs), batch_sh["tokens"],
             P()), meta)


def _local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    sizes = mesh_axes(mesh)
    out = list(shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                out[d] //= sizes[a]
    return tuple(out)


def _flat(tree):
    """Leaves of a nested dict or AdamWState of trees (a (shape, dtype)
    pair or a ``P`` is a leaf), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    elif isinstance(tree, AdamWState):
        for t in tree:
            yield from _flat(t)
    else:
        yield tree


def argument_bytes(shapes, specs, mesh) -> int:
    """Bytes of one device's shards of every argument (the reference's
    ``NamedSharding.shard_shape`` sum); ``shapes`` and ``specs`` as
    ``lowering_specs`` gives them."""
    total = 0
    for arg_shapes, arg_specs in zip(shapes, specs):
        for (s, dt), spec in zip(_flat(arg_shapes), _flat(arg_specs)):
            total += math.prod(_local_shape(s, spec, mesh)) * dt.itemsize
    return total


def _placements(spec, mesh):
    if isinstance(spec, dict):
        return {k: _placements(v, mesh) for k, v in spec.items()}
    if isinstance(spec, AdamWState):
        return AdamWState(*(_placements(t, mesh) for t in spec))
    return placements(spec, mesh)


def build_lowering(arch_id: str, shape_name: str, mesh,
                   opt_cfg: AdamWConfig = AdamWConfig(),
                   zero1: bool = True, microbatch: int = 1,
                   zero2: bool = False, kv_quant: bool = False):
    """(step, args, placements, meta) for ``step(*args)`` on the
    DeviceMesh ``mesh``: ``args`` are DTensors of fake tensors made under
    ``meta["fake_mode"]`` (run the step under it, and under
    ``use_mesh(mesh)``), ``placements`` their placement trees."""
    model, names, shapes, specs, meta = lowering_specs(
        arch_id, shape_name, mesh, zero1=zero1, kv_quant=kv_quant)
    model = dataclasses.replace(model, ops=HOST_OPS, scan_ops=HOST_SCAN_OPS)
    meta["model"] = model
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    meta["fake_mode"] = mode
    meta["argument_bytes"] = argument_bytes(shapes, specs, mesh)

    def fake(sd, spec, grad=False):
        s, dt = sd
        local = torch.empty(_local_shape(s, spec, mesh), dtype=dt,
                            device=mesh.device_type)
        t = DTensor.from_local(local, mesh, placements(spec, mesh),
                               run_check=False, shape=torch.Size(s),
                               stride=_contiguous_stride(s))
        return t.requires_grad_() if grad else t

    with mode:
        if meta["kind"] == "train":
            params_abs, opt_abs, batch_abs = shapes
            params_sh, opt_sh, batch_sh = specs
            params = _map(lambda sd, sp: fake(sd, sp, True), params_abs,
                          params_sh)
            opt = AdamWState(torch.zeros((), dtype=torch.int32),
                             _map(fake, opt_abs.m, opt_sh.m),
                             _map(fake, opt_abs.v, opt_sh.v))
            batch = _map(fake, batch_abs, batch_sh)
            args = (params, opt, batch)
            step = make_train_step(model, opt_cfg, microbatch=microbatch,
                                   grad_sharding=meta["zero1"] if zero2
                                   else None)
        elif meta["kind"] == "prefill":
            args = tuple(_map(fake, a, s) for a, s in zip(shapes, specs))
            plan = meta["plan"]

            def step(params, batch):
                return model.prefill_fn(params, batch, cache_len=plan.length,
                                        ring=plan.ring)
        else:
            params, cache, tokens = (_map(fake, a, s) for a, s in
                                     zip(shapes[:3], specs[:3]))
            plan = meta["plan"]
            # the last position of the seq_len cache
            pos = get_shape(shape_name).seq_len - 1
            args = (params, cache, tokens, pos)

            def step(params, cache, tokens, pos):
                return model.decode_fn(params, cache, tokens, pos,
                                       ring=plan.ring)
    pl = tuple(_placements(sp, mesh) for sp in specs)
    return step, args, pl, meta


def _host_ssm_scan(x, dt, a_log, b, c, d_skip, state=None):
    scan = ssm_ops.ssm_scan_chunked_plain if ssm_ops.uses_chunks(
        x.shape[1]) else ssm_ops.ssm_scan_plain
    return scan(x, dt, a_log, b, c, d_skip, state)


def _host_mlstm_scan(q, k, v, ig, fg, state=None):
    scan = mlstm_ops.mlstm_scan_chunked_plain if mlstm_ops.uses_chunks(
        q.shape[1]) else mlstm_ops.mlstm_scan_plain
    return scan(q, k, v, ig, fg, state)


# the dry-run's kernels, on the host: their plain versions, the scans in
# the kernels' own chunked form, whose loop runs S / chunk times, not S
HOST_OPS = dataclasses.replace(transformer.PLAIN_OPS,
                               ssm_scan=_host_ssm_scan)
HOST_SCAN_OPS = xlstm.ScanOps(_host_mlstm_scan)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))
