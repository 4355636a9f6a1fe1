"""The port's sharded paths on gloo meshes of CPU processes, against the
unsharded port and the JAX reference on the same weights (float32).

Each job runs in a subprocess (``tests/torch_mesh_worker.py``) that
spawns one process per device of the mesh, joined over a ``FileStore``
in ``tmp_path``. On a 2x2 mesh: reduced qwen3-1.7b prefill, 4 decode
steps, loss and every grad leaf, and one AdamW step without ZeRO, with
ZeRO-1 (m and v sharded over ``data``) and ZeRO-2 (microbatch 2, grads
and accumulator sharded too). On 2x3 and 2x2 meshes: ``moe_apply_ep``
on reduced granite-moe-3b-a800m (4 experts: not divisible by 3, so
replicated weights and clamped windows; divisible by 2, so sharded
weights) against ``moe_apply`` and the reference's ``moe_apply_ep`` on
an Auto-axis host mesh of the same shape, with the gradients of
``sum(y * r) + aux``. On a 2x2 mesh, the other families reduced (hymba,
xlstm, whisper, granite through ``moe_apply_ep``, llava): prefill, 2
decode steps, loss and every grad leaf against the unsharded port.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training.trainer import make_train_step as ref_step  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.trainer import make_train_step, \
    trainable  # noqa: E402

TOL = 1e-5
FAMILY_TOL = 1e-4
TIMEOUT = 420
B, S, STEPS = 4, 16, 4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    """The sharded outputs of the 2x2 job, the unsharded port's and the
    reference's, on one seeded set of weights and tokens."""
    work = tmp_path_factory.mktemp("qwen_2x2")
    rcfg = ref_config("qwen3-1.7b").reduced()
    host = jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    dec = rng.integers(0, rcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    train = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    np.savez(work / "in.npz", tokens=tokens, decode_tokens=dec,
             train_tokens=train,
             **{f"p/{k}": v for k, v in worker.flatten(host).items()})
    (work / "job.json").write_text(json.dumps(
        {"arch": "qwen3-1.7b", "mesh": {"data": 2, "model": 2},
         "opt": OPT}))
    worker.run("qwen", 4, work, TIMEOUT)
    with np.load(work / "out.npz") as f:
        out = dict(f)

    # the reference
    ref = {}
    logits, cache = ref_tf.prefill(rcfg, host, jnp.asarray(tokens),
                                   cache_len=S + STEPS)
    ref["prefill"] = np.asarray(logits)
    for i in range(STEPS):
        logits, cache = ref_tf.decode_step(rcfg, host, cache,
                                           jnp.asarray(dec[i]), S + i)
        ref[f"decode{i}"] = np.asarray(logits)
    ref["cache"] = _leaves_np(cache)
    rmodel = ref_build(rcfg)
    rb = {"tokens": jnp.asarray(train), "labels": jnp.asarray(train)}
    (loss, _), grads = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, host), rb)
    ref["loss"], ref["grads"] = float(loss), _leaves_np(grads)
    rocfg = ref_opt.AdamWConfig(**OPT)
    rparams = jax.tree.map(jnp.asarray, host)
    rnew, rstate, rmet = jax.jit(ref_step(rmodel, rocfg))(
        rparams, ref_opt.adamw_init(rparams, rocfg), rb)
    ref["step"] = (_leaves_np(rnew), _leaves_np(rstate.m),
                   float(rmet["grad_norm"]))

    # the unsharded port
    pcfg = get_config("qwen3-1.7b").reduced()
    model = build_model(pcfg)
    params = params_from_jax(host, "cpu")
    port = {}
    logits, cache = model.prefill_fn(params,
                                     {"tokens": torch.from_numpy(tokens)},
                                     cache_len=S + STEPS)
    port["prefill"] = logits.numpy()
    for i in range(STEPS):
        logits, cache = model.decode_fn(params, cache,
                                        torch.from_numpy(dec[i]), S + i)
        port[f"decode{i}"] = logits.numpy()
    port["cache"] = [t.numpy() for t in tree_leaves(cache)]
    pb = {"tokens": torch.from_numpy(train),
          "labels": torch.from_numpy(train)}
    tp = trainable(params)
    loss, _ = model.loss_fn(tp, pb)
    port["loss"] = float(loss.detach())
    port["grads"] = [g.numpy() for g in
                     torch.autograd.grad(loss, list(tree_leaves(tp)))]
    ocfg = opt.AdamWConfig(**OPT)
    tp = trainable(params)
    pnew, pstate, pmet = make_train_step(model, ocfg)(
        tp, opt.adamw_init(tp, ocfg), pb)
    port["step"] = ([t.detach().numpy() for t in tree_leaves(pnew)],
                    [t.numpy() for t in tree_leaves(pstate.m)],
                    float(pmet["grad_norm"]))
    return out, port, ref


def _close(got, want, what, tol=TOL):
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol, (what, err)
    return err


def _close_after_adamw(got, want, what, lr=OPT["lr"], tol=TOL):
    """Parameters after one AdamW step: within tol of the leaf's largest
    |p| but for at most max(1, 1e-4 n) of its n entries, and those within
    2 lr (``test_torch_training.assert_close_after_adamw``: an update is
    scale-free in g, so an entry whose grad lies at the two sides'
    rounding level may move by its whole size)."""
    diff = np.abs(got - want)
    assert (diff <= 2 * lr).all(), (what, diff.max())
    n = int((diff > tol * max(np.abs(want).max(), 1.0)).sum())
    assert n <= max(1, 1e-4 * diff.size), (what, n, diff.size)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_sharded_prefill_and_decode_match(qwen, side):
    out, port, ref = qwen
    want = port if side == "port" else ref
    _close(out["prefill"], want["prefill"], "prefill logits")
    for i in range(STEPS):
        _close(out[f"decode{i}"], want[f"decode{i}"], f"decode {i}")
    for i, w in enumerate(want["cache"]):
        _close(out[f"cache/{i}"], np.asarray(w, np.float32), f"cache {i}")


@pytest.mark.parametrize("side", ["port", "reference"])
def test_sharded_loss_and_grads_match(qwen, side):
    out, port, ref = qwen
    want = port if side == "port" else ref
    assert abs(float(out["loss"]) - want["loss"]) <= TOL
    for i, w in enumerate(want["grads"]):
        _close(out[f"grad/{i}"], w, f"grad leaf {i}")


@pytest.mark.parametrize("side", ["port", "reference"])
def test_sharded_train_step_matches(qwen, side):
    out, port, ref = qwen
    params, m, gn = (port if side == "port" else ref)["step"]
    assert abs(float(out["step/grad_norm"]) - gn) <= TOL * gn
    for i, (p, mi) in enumerate(zip(params, m)):
        _close(out[f"step/m/{i}"], mi, f"m leaf {i}")
        _close_after_adamw(out[f"step/p/{i}"], p, f"param leaf {i}")


@pytest.mark.parametrize("zero", ["zero1", "zero2"])
def test_zero_steps_match_unsharded_step(qwen, zero):
    """ZeRO-1 (m, v sharded over data) and ZeRO-2 (also the grads and
    their float32 accumulator, in 2 microbatches) against the unsharded
    port's one-shot step, per leaf; the worker checks that m stays in the
    ZeRO layout."""
    out, port, _ = qwen
    params, m, gn = port["step"]
    assert abs(float(out[f"{zero}/grad_norm"]) - gn) <= TOL * gn
    assert abs(float(out[f"{zero}/loss"]) - port["loss"]) <= TOL
    for i, (p, mi) in enumerate(zip(params, m)):
        _close(out[f"{zero}/m/{i}"], mi, f"{zero} m leaf {i}")
        _close_after_adamw(out[f"{zero}/p/{i}"], p, f"{zero} leaf {i}")


@pytest.mark.parametrize("data,model", [(2, 3), (2, 2)])
def test_moe_apply_ep_matches_moe_apply_and_reference(tmp_path, data,
                                                      model):
    rcfg = ref_config("granite-moe-3b-a800m").reduced()
    host = jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(9)))
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 8, rcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, r=r,
             **{f"p/{k}": v for k, v in worker.flatten(host).items()})
    (tmp_path / "job.json").write_text(json.dumps(
        {"arch": "granite-moe-3b-a800m",
         "mesh": {"data": data, "model": model}}))
    world = data * model
    worker.run("moe", world, tmp_path, TIMEOUT)
    worker.run("jax_moe_ep", world, tmp_path, TIMEOUT)
    with np.load(tmp_path / "out.npz") as f:
        out = dict(f)
    with np.load(tmp_path / "ref_out.npz") as f:
        ref = dict(f)
    y, aux, ry, raux = out["y"], float(out["aux"]), ref["y"], \
        float(ref["aux"])
    pcfg = get_config("granite-moe-3b-a800m").reduced()
    p = {k: torch.from_numpy(np.array(host["layers"][k][0]))
         for k in ("router", "we1", "we3", "we2")}
    py, paux = moe.moe_apply(pcfg, p, torch.from_numpy(x))
    _close(y, py.numpy(), "moe_apply_ep vs moe_apply")
    _close(y, ry, "moe_apply_ep vs reference moe_apply_ep")
    # the reference on one device
    jy, _ = ref_moe.moe_apply(rcfg, {k: jnp.asarray(host["layers"][k][0])
                                     for k in p}, jnp.asarray(x))
    _close(y, np.asarray(jy), "moe_apply_ep vs reference moe_apply")
    # the expert-parallel aux loss is the mean of each data shard's, as the
    # reference's is (its pmean), not moe_apply's over the whole batch
    assert abs(aux - raux) <= TOL, (aux, raux, float(paux))
    # the gradients of sum(y * r) + aux, against the reference's
    # shard_map transpose: x, the router and each expert weight
    # the router's grads sum every token's: 1e-5 of the leaf's largest
    for k in ("x", "router", "we1", "we3", "we2"):
        want = ref[f"grad/{k}"]
        _close(out[f"grad/{k}"], want, f"grad {k}",
               TOL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def archs(tmp_path_factory):
    work = tmp_path_factory.mktemp("archs_2x2")
    np.savez(work / "in.npz", none=np.zeros(1))
    (work / "job.json").write_text(json.dumps(
        {"mesh": {"data": 2, "model": 2}}))
    worker.run("archs", 4, work, TIMEOUT)
    with np.load(work / "out.npz") as f:
        return dict(f)


@pytest.mark.parametrize("case,arch,ep", worker.ARCHS,
                         ids=[c for c, _, _ in worker.ARCHS])
def test_sharded_families_match_unsharded(archs, case, arch, ep):
    """The sharded hybrid (its SSM scan on local heads), xLSTM and
    Whisper blocks (on local batch shards), MoE (expert-parallel, and the
    replicated dispatch under ``REPRO_MOE_EP=0``) and VLM paths against
    the same reduced model unsharded, at these families' parity
    tolerance (``tests/test_torch_hymba.py`` and the others hold them to
    the reference at 1e-4): the logits, the loss and each grad leaf at
    1e-4 of its largest entry (absolute under 1). The expert-parallel
    loss is held by its logits only: its aux term is the mean of each
    data shard's, as the reference's is, not the whole batch's."""
    want = worker.arch_run(arch)
    got = {k[len(case) + 1:]: v for k, v in archs.items()
           if k.startswith(case + "/")}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if ep == "1" and arch.startswith("granite") and \
                not k.startswith(("prefill", "decode")):
            continue
        _close(got[k], w, f"{case} {k}",
               FAMILY_TOL * max(1.0, float(np.abs(w).max())))
