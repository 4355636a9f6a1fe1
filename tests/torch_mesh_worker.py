"""Multi-process jobs for ``tests/test_torch_mesh_dist.py``.

``run(job, world, workdir, timeout)`` starts this file in a subprocess,
which spawns ``world`` CPU processes joined by a gloo group over a
``FileStore`` in ``workdir`` (no network). Each rank reads the job's
inputs from ``workdir/in.npz`` and ``workdir/job.json``, runs the port's
sharded step on a DeviceMesh, and rank 0 writes the full tensors to
``workdir/out.npz``. The ``jax_moe_ep`` job instead runs the reference's
``moe_apply_ep`` on an Auto-axis host mesh of six devices, in its own
process because the host device count must be set before JAX starts.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run(job: str, world: int, workdir, timeout: float) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, __file__, job, str(world),
                          str(workdir)], env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# --- the port's jobs, one per rank ---------------------------------------------

def _tensor_tree(flat):
    import torch
    return unflatten({k: torch.from_numpy(np.array(v)) for k, v in
                      flat.items()})


def _full(x):
    from torch.distributed.tensor import DTensor
    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().numpy()


def _full_tree(tree, prefix):
    from repro_torch.models.common import tree_leaves
    return {f"{prefix}{i}": _full(t) for i, t in
            enumerate(tree_leaves(tree))}


def job_qwen(rank, mesh, inp, cfg_json):
    """Prefill, decode steps, loss and grads, and one train step without
    ZeRO, with ZeRO-1 and with ZeRO-2 (microbatch 2)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import zero1_shardings
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import make_train_step, trainable
    from repro_torch.utils.shardctx import (P, constrain, distribute,
                                            placements, use_mesh)

    cfg = get_config(cfg_json["arch"]).reduced()
    model = build_model(cfg)
    host = _tensor_tree({k[2:]: v for k, v in inp.items()
                         if k.startswith("p/")})
    specs = model.partition_specs(mesh)
    params = distribute(host, specs, mesh)

    def batch(x):
        return distribute(torch.from_numpy(x), P("data"), mesh)

    out = {}
    with use_mesh(mesh):
        tokens = batch(inp["tokens"])
        S = tokens.shape[1]
        steps = inp["decode_tokens"].shape[0]
        logits, cache = model.prefill_fn(params, {"tokens": tokens},
                                         cache_len=S + steps)
        out["prefill"] = _full(logits)
        for i in range(steps):
            logits, cache = model.decode_fn(
                params, cache, batch(inp["decode_tokens"][i]), S + i)
            out[f"decode{i}"] = _full(logits)
        out.update(_full_tree(cache, "cache/"))

        tb = {"tokens": batch(inp["train_tokens"]),
              "labels": batch(inp["train_tokens"])}
        tp = trainable(params)
        loss, _ = model.loss_fn(tp, tb)
        grads = torch.autograd.grad(loss, list(tree_leaves(tp)))
        out["loss"] = _full(loss)
        out.update(_full_tree(list(grads), "grad/"))

        ocfg = opt.AdamWConfig(**cfg_json["opt"])
        z1 = zero1_shardings(mesh, model)
        for name, K, zero in (("step", 1, None), ("zero1", 1, "m/v"),
                              ("zero2", 2, "grads")):
            p = trainable(params)
            state = opt.adamw_init(p, ocfg)
            if zero:
                # ZeRO-1: m and v stored in the ZeRO layout
                state = opt.AdamWState(state.step, constrain(state.m, z1),
                                       constrain(state.v, z1))
            step = make_train_step(model, ocfg, microbatch=K,
                                   grad_sharding=z1 if zero == "grads"
                                   else None)
            p, state, met = step(p, state, tb)
            out.update(_full_tree(p, f"{name}/p/"))
            out.update(_full_tree(state.m, f"{name}/m/"))
            out[f"{name}/loss"] = _full(met["loss"])
            out[f"{name}/grad_norm"] = _full(met["grad_norm"])
            if zero:
                # the moments stay in the ZeRO layout
                for t, s in zip(tree_leaves(state.m), tree_leaves(z1)):
                    assert list(t.placements) == placements(s, mesh), \
                        (t.placements, s)
    return out


def job_moe(rank, mesh, inp, cfg_json):
    """``moe_apply_ep`` on layer 0 of a reduced MoE config."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe
    from repro_torch.utils.shardctx import P, distribute, use_mesh

    cfg = get_config(cfg_json["arch"]).reduced()
    model = build_model(cfg)
    host = _tensor_tree({k[2:]: v for k, v in inp.items()
                         if k.startswith("p/")})
    layer = {k: host["layers"][k][0] for k in
             ("router", "we1", "we3", "we2")}
    specs = model.partition_specs(mesh)["layers"]
    lspecs = {k: P(*specs[k][1:]) for k in layer}
    with use_mesh(mesh):
        p = {k: t.requires_grad_() for k, t in
             distribute(layer, lspecs, mesh).items()}
        x = distribute(torch.from_numpy(inp["x"]), P("data"),
                       mesh).requires_grad_()
        y, aux = moe.moe_apply_ep(cfg, p, x)
        r = distribute(torch.from_numpy(inp["r"]), P("data"), mesh)
        loss = (y * r).sum() + aux
        grads = torch.autograd.grad(loss, [x] + [p[k] for k in MOE_LEAVES])
        out = {"y": _full(y), "aux": _full(aux)}
        out.update({f"grad/{k}": _full(g) for k, g in
                    zip(("x",) + MOE_LEAVES, grads)})
        return out


MOE_LEAVES = ("router", "we1", "we3", "we2")


# (case, arch, REPRO_MOE_EP): granite both through moe_apply_ep and
# through the replicated dispatch of moe_apply
ARCHS = (("hymba-1.5b", "hymba-1.5b", "1"),
         ("xlstm-350m", "xlstm-350m", "1"),
         ("whisper-large-v3", "whisper-large-v3", "1"),
         ("granite-moe-3b-a800m", "granite-moe-3b-a800m", "1"),
         ("granite-moe-3b-a800m-ep0", "granite-moe-3b-a800m", "0"),
         ("llava-next-mistral-7b", "llava-next-mistral-7b", "1"))
ARCH_B, ARCH_S, ARCH_STEPS = 4, 24, 2


def arch_run(arch, ep="1", mesh=None):
    """Reduced ``arch`` (float32, weights and inputs from seed 0): the
    prefill logits, ``ARCH_STEPS`` decode steps' logits on fed tokens,
    the loss and every grad leaf; sharded by its specs under ``mesh``,
    with ``REPRO_MOE_EP`` set to ``ep``."""
    import contextlib
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, decode_cache_plan
    from repro_torch.models.common import tree_leaves
    from repro_torch.shapes import InputShape
    from repro_torch.training.trainer import trainable
    from repro_torch.utils.shardctx import P, distribute, use_mesh

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    prompt = model.make_batch(InputShape("p", ARCH_S, ARCH_B, "prefill"),
                              g, "cpu")
    train = model.make_batch(InputShape("t", ARCH_S, ARCH_B, "train"), g,
                             "cpu")
    fed = torch.randint(0, cfg.vocab_size, (ARCH_STEPS, ARCH_B, 1),
                        generator=g, dtype=torch.int32)
    plan = decode_cache_plan(cfg, ARCH_S + ARCH_STEPS)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        params = distribute(params, model.partition_specs(mesh), mesh)
        prompt, train = ({k: distribute(v, P("data"), mesh)
                          for k, v in b.items()} for b in (prompt, train))
        fed = distribute(fed, P(None, "data"), mesh)
        ctx = use_mesh(mesh)
    out = {}
    prev = os.environ.get("REPRO_MOE_EP")
    os.environ["REPRO_MOE_EP"] = ep
    with ctx:
        with torch.no_grad():
            logits, cache = model.prefill_fn(params, prompt, plan.length,
                                             plan.ring)
            out["prefill"] = _full(logits)
            pos = model.decode_start(prompt)
            for i in range(ARCH_STEPS):
                logits, cache = model.decode_fn(params, cache, fed[i],
                                                pos + i, plan.ring)
                out[f"decode{i}"] = _full(logits)
        tp = trainable(params)
        loss, _ = model.loss_fn(tp, train)
        grads = torch.autograd.grad(loss, list(tree_leaves(tp)))
        out["loss"] = _full(loss)
        out.update({f"grad/{i}": _full(t) for i, t in enumerate(grads)})
    if prev is None:
        del os.environ["REPRO_MOE_EP"]
    else:
        os.environ["REPRO_MOE_EP"] = prev
    return out


def job_archs(rank, mesh, inp, cfg_json):
    """``arch_run`` of every arch in ``ARCHS`` on the mesh."""
    return {f"{case}/{k}": v for case, arch, ep in ARCHS
            for k, v in arch_run(arch, ep, mesh).items()}


JOBS = {"qwen": job_qwen, "moe": job_moe, "archs": job_archs}


def _rank_main(rank, job, world, workdir):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    workdir = Path(workdir)
    cfg_json = json.loads((workdir / "job.json").read_text())
    store = dist.FileStore(str(workdir / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_test_mesh(**cfg_json["mesh"])
        with np.load(workdir / "in.npz") as f:
            inp = dict(f)
        out = JOBS[job](rank, mesh, inp, cfg_json)
        if rank == 0:
            np.savez(workdir / "out.npz", **out)
    finally:
        dist.destroy_process_group()


# --- the reference's expert-parallel MoE on a host mesh ----------------------

def jax_moe_ep(world, workdir):
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={world}"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config
    from repro.models import moe
    from repro.utils.shardctx import use_mesh

    workdir = Path(workdir)
    cfg_json = json.loads((workdir / "job.json").read_text())
    m = cfg_json["mesh"]
    cfg = get_config(cfg_json["arch"]).reduced()
    with np.load(workdir / "in.npz") as f:
        inp = dict(f)
    p = {k: jnp.asarray(inp[f"p/layers/{k}"][0])
         for k in ("router", "we1", "we3", "we2")}
    # Auto axes: jax.make_mesh's default Explicit axes refuse the
    # reference's sharding constraints (ROADMAP.md section 3)
    mesh = jax.make_mesh((m["data"], m["model"]), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    r = jnp.asarray(inp["r"])

    def loss(p, x):
        y, aux = moe.moe_apply_ep(cfg, p, x)
        return (y * r).sum() + aux, (y, aux)

    with use_mesh(mesh):
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(inp["x"]))
    np.savez(workdir / "ref_out.npz", y=np.asarray(y), aux=np.asarray(aux),
             **{"grad/x": np.asarray(gx)},
             **{f"grad/{k}": np.asarray(v) for k, v in gp.items()})


if __name__ == "__main__":
    job, world, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    if job == "jax_moe_ep":
        jax_moe_ep(world, workdir)
    else:
        import torch.multiprocessing as mp
        mp.spawn(_rank_main, args=(job, world, workdir), nprocs=world,
                 join=True)
