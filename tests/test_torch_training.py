"""The port's training path (``repro_torch.training``, ``Model.loss_fn``)
against ``repro``'s on the reference's own weights, on the CPU.

Reduced configs in float32; inputs from numpy seeds; the JAX weights go
through ``repro_torch.bridge``. Tolerances:

- ``cross_entropy``: 1e-6 absolute, ``-1`` labels masked.
- ``Model.loss_fn`` for qwen3 (dense), granite-moe (MoE: dropless, and
  T * k = 4160 > 4096, where the capacity bound drops pairs), llava
  (VLM), hymba (hybrid), xlstm and whisper: the loss at 1e-5 relative,
  every gradient leaf within 1e-4 of the leaf's largest |g| (2e-5 for
  the dense family), against ``jax.value_and_grad``.
- ``lr_schedule``: 1e-6 relative. ``adamw_update`` on the same grads:
  the moments at 1e-6 of their leaf's largest value; the parameters at
  1e-6 of the leaf's largest |p| (one bf16 step for a bf16 leaf) where
  |g| > 1e-6 max |g| of the leaf, and within lr elsewhere: one AdamW
  step is close to lr * sign(g), so where |g| is near eps a rounding in
  g may move the update by up to lr.
- ``microbatch=4`` against ``microbatch=1`` (the counterpart of
  ``tests/test_substrate.py::TestMicrobatchTrainStep``): loss 2e-3,
  the grad norm at 1e-5 relative, the accumulated grads (the first
  step's m, unclipped) at 1e-5 of each leaf's largest |m|, parameters
  5e-3. ``microbatch=4`` against the reference's ``microbatch=4``:
  metrics at 1e-5 relative, m at 2e-5 of each leaf's largest |m|, the
  parameters as below.
- Three ``Trainer`` steps against the JAX ``Trainer`` on the same
  weights and ``batches``: losses, lr and grad norms at 1e-5 relative,
  the parameters after the third step at 1e-4 of each leaf's largest
  |p| but for at most max(1, 1e-4 n) of a leaf's n entries, which lie
  within 2 * (lr summed over the steps): ``assert_close_after_adamw``
  says why.
- Checkpoints both ways: the reference's float32 and bfloat16 files
  restore in the port bit for bit; the port's file has the reference's
  keys, and its float32 leaves restore through
  ``repro.training.checkpoint.restore`` bit for bit.
- The kernel wrappers refuse inputs that autograd records.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.training import Trainer as RefTrainer  # noqa: E402
from repro.training import checkpoint as ref_ckpt  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training.trainer import \
    make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as k4  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as k5  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.training import AdamWConfig, DataConfig, Trainer, \
    batches  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.trainer import make_train_step, \
    trainable  # noqa: E402

LOSS_REL = 1e-5
GRAD_TOL = {"dense": 2e-5}
GRAD_TOL_OTHER = 1e-4


def _np_leaves(tree):
    """The leaves of a JAX tree of dicts in sorted-key order, as numpy."""
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _host(rcfg, seed):
    return jax.tree.map(np.asarray,
                        ref_build(rcfg).init_params(jax.random.PRNGKey(seed)))


# --- cross_entropy ----------------------------------------------------------

def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 33)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 5] = -1
    want = float(ref_common.cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = float(common.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6, (got, want)
    none = np.full_like(labels, -1)
    assert float(common.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(none))) == 0.0


# --- Model.loss_fn and its gradients ------------------------------------------

def _skewed_router(host, rcfg, seed):
    """Every token's hidden state gets a common offset (added to every
    embedding row) and router column 0 is tilted along it, so expert 0
    is everyone's first choice and overflows its capacity."""
    u = np.random.default_rng(seed).normal(size=rcfg.d_model)
    host["emb"] = (host["emb"] + 0.1 * u).astype(np.float32)
    router = np.array(host["layers"]["router"])
    router[:, :, 0] += 0.05 * u
    host["layers"]["router"] = router.astype(np.float32)


def _perturb_ssm(host, seed):
    """a_log, d_skip and dt_bias from a seed: the reference's init makes
    every head alike (A = -1, D = 1)."""
    rng = np.random.default_rng(seed)
    lay = host["layers"]
    for name, scale, shift in [("a_log", 0.3, 0.0), ("d_skip", 1.0, 0.0),
                               ("dt_bias", 0.5, -0.5)]:
        lay[name] = (rng.normal(size=lay[name].shape) * scale
                     + shift).astype(np.float32)


LOSS_CASES = {
    # arch, B, S (text positions), extra host edit
    "qwen3": ("qwen3-1.7b", 2, 40, None),
    "granite-dropless": ("granite-moe-3b-a800m", 2, 48, None),
    "granite-capacity": ("granite-moe-3b-a800m", 2, 1040, _skewed_router),
    "llava": ("llava-next-mistral-7b", 2, 88, None),
    "hymba": ("hymba-1.5b", 1, 128, None),
    "xlstm": ("xlstm-350m", 1, 128, None),
    "whisper": ("whisper-large-v3", 2, 40, None),
}


def _batch(rcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[0, 5:9] = -1          # masked positions
    batch = {"tokens": tokens, "labels": labels}
    if rcfg.family == "vlm":
        batch["patch_embeds"] = (rng.normal(size=(B, rcfg.n_patches,
                                                  rcfg.d_model)) * 0.02
                                 ).astype(np.float32)
    if rcfg.family == "audio":
        batch["frames"] = (rng.normal(size=(B, rcfg.encoder_len,
                                            rcfg.d_model)) * 0.02
                           ).astype(np.float32)
    return batch


def _routing_spy(monkeypatch, seen):
    """Wrap the port's ``moe_apply`` to record, per call, the largest
    expert load over the capacity and the smallest top-k gap of the
    router logits (float64)."""
    orig = port_moe.moe_apply

    def spy(cfg, p, x):
        xf = x.detach().reshape(-1, x.shape[-1]).double()
        logits = xf @ p["router"].detach().double()
        top = torch.sort(logits, -1, descending=True).values
        gap = float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min())
        idx = torch.topk(logits, cfg.top_k).indices.flatten()
        load = int(torch.bincount(idx, minlength=cfg.n_experts).max())
        seen.append((load - port_moe.capacity(cfg, xf.shape[0]), gap))
        return orig(cfg, p, x)
    monkeypatch.setattr(port_moe, "moe_apply", spy)


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_reference(case, monkeypatch):
    arch, B, S, edit = LOSS_CASES[case]
    rcfg, pcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    host = _host(rcfg, 11)
    if rcfg.family == "hybrid":
        _perturb_ssm(host, 12)
    if edit is not None:
        edit(host, rcfg, 13)
    batch = _batch(rcfg, B, S, 14)

    model = ref_build(rcfg)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()}),
        has_aux=True))(jax.tree.map(jnp.asarray, host))

    seen = []
    _routing_spy(monkeypatch, seen)
    params = trainable(params_from_jax(host, device="cpu"))
    loss, met = build_model(pcfg).loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tree_leaves(params)))

    if pcfg.is_moe:
        # no router near-tie (a tie may send a pair to other experts on
        # the two sides); the capacity case drops pairs, the other none
        assert min(g for _, g in seen) > 1e-5, seen
        over = max(o for o, _ in seen)
        assert (over > 0) == (case == "granite-capacity"), seen
    for name, want, got in [("loss", rloss, loss), ("ce", rmet["ce"],
                                                    met["ce"]),
                            ("aux", rmet["aux"], met["aux"])]:
        want, got = float(want), float(got.detach())
        assert abs(got - want) <= LOSS_REL * max(abs(want), 1e-6), \
            (name, got, want)
    tol = GRAD_TOL.get(pcfg.family, GRAD_TOL_OTHER)
    ref_leaves = _np_leaves(rgrads)
    assert len(ref_leaves) == len(grads)
    for i, (want, got) in enumerate(zip(ref_leaves, grads)):
        assert got is not None and got.shape == want.shape, i
        scale = float(np.abs(want).max())
        err = float(np.abs(got.numpy() - want).max())
        assert err <= tol * max(scale, 1e-30), (i, err, scale)


# --- AdamW --------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=50)
    rcfg = ref_opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=50)
    for step in (0, 1, 10, 30, 50, 60):
        want = float(ref_opt.lr_schedule(jnp.int32(step), rcfg))
        got = float(opt.lr_schedule(torch.tensor(step, dtype=torch.int32),
                                    cfg))
        assert abs(got - want) <= 1e-6 * want + 1e-12, (step, got, want)


def _adamw_inputs(seed):
    """A float32 and a bfloat16 leaf, grads with entries near eps."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(64, 48)).astype(np.float32),
              "b": {"c": (rng.normal(size=(96,)) * 0.1).astype(np.float32)}}
    grads = {"a": (rng.normal(size=(64, 48)) * 0.3).astype(np.float32),
             "b": {"c": (rng.normal(size=(96,)) * 1e-2).astype(np.float32)}}
    grads["a"][0, :8] = np.float32(3e-9) * rng.normal(size=8)
    return params, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                      grad_clip=0.5)
    rcfg = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                               grad_clip=0.5)
    params, grads = _adamw_inputs(1)
    jdt = getattr(jnp, dtype)
    rparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    rgrads = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), grads)
    rnew, rstate, rmet = ref_opt.adamw_update(
        rgrads, ref_opt.adamw_init(rparams, rcfg), rparams, rcfg)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), "cpu")
    pgrads = params_from_jax(jax.tree.map(np.asarray, rgrads), "cpu")
    pnew, pstate, pmet = opt.adamw_update(
        pgrads, opt.adamw_init(pparams, cfg), pparams, cfg)

    assert int(pstate.step) == int(rstate.step) == 1
    assert pstate.step.dtype == torch.int32
    for k in ("lr", "grad_norm"):
        want, got = float(rmet[k]), float(pmet[k])
        assert abs(got - want) <= 1e-6 * abs(want), (k, got, want)
    for rt, pt in [(rstate.m, pstate.m), (rstate.v, pstate.v)]:
        for want, got in zip(_np_leaves(rt), tree_leaves(pt)):
            assert got.dtype == torch.float32
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-6 * np.abs(want).max(), err
    for want, got, g in zip(_np_leaves(rnew), tree_leaves(pnew),
                            tree_leaves(pgrads)):
        assert str(got.dtype) == f"torch.{dtype}"
        want = want.astype(np.float32)
        got = got.float().numpy()
        g = np.abs(g.float().numpy())
        big = g > 1e-6 * g.max()
        diff = np.abs(got - want)
        if dtype == "bfloat16":
            tight = diff <= 2.0 ** -8 * np.abs(want)   # one bf16 step
        else:
            tight = diff <= 1e-6 * np.abs(want).max()
        assert tight[big].all(), diff[big & ~tight]
        assert (diff[~big] <= cfg.lr).all()


def test_optimizer_rejects_shardings():
    p = {"w": torch.zeros(2)}
    cfg = AdamWConfig()
    with pytest.raises(ValueError, match="item 18"):
        opt.adamw_update(p, opt.adamw_init(p, cfg), p, cfg, shardings={})
    with pytest.raises(ValueError, match="item 18"):
        make_train_step(None, cfg, grad_sharding={})


# --- the train step -----------------------------------------------------------

def test_microbatch_matches_full_batch():
    """Gradient accumulation must match the single-shot step. Without a
    clip, the first step's m is (1 - b1) times the grads, so m and the
    grad norm hold the accumulated grads (the parameters after one step
    move by about lr * sign(g) whatever the grads)."""
    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          grad_clip=math.inf)
    init = model.init_params(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (8, 32),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    out = {}
    for K in (1, 4):
        params = trainable(init)
        params, state, m = make_train_step(model, opt_cfg, microbatch=K)(
            params, opt.adamw_init(params, opt_cfg), batch)
        out[K] = (params, state, m)
    (p1, s1, m1), (p4, s4, m4) = out[1], out[4]
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-3
    assert abs(float(m1["ce"]) - float(m4["ce"])) < 2e-3
    gn1, gn4 = float(m1["grad_norm"]), float(m4["grad_norm"])
    assert abs(gn4 - gn1) <= 1e-5 * gn1, (gn1, gn4)
    # the accumulated grads: 1e-5 of each leaf's largest |m|
    for i, (a, b) in enumerate(zip(tree_leaves(s1.m), tree_leaves(s4.m))):
        err = float((a - b).abs().max())
        assert err <= 1e-5 * float(a.abs().max()), (i, err)
    worst = max(float((a - b).detach().abs().max())
                for a, b in zip(tree_leaves(p1), tree_leaves(p4)))
    assert worst < 5e-3, f"param divergence {worst}"
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, opt_cfg, microbatch=3)(
            trainable(init), opt.adamw_init(init, opt_cfg), batch)


def test_microbatch_step_matches_reference():
    """One ``make_train_step(microbatch=4)`` step of the port against the
    reference's on the same weights and batch: loss, metrics and grad
    norm at 1e-5 relative; m, (1 - b1) times the clipped accumulated
    grads, at the dense family's grad tolerance of each leaf's largest
    |m|; the parameters as ``assert_close_after_adamw`` says."""
    rcfg, pcfg = ref_config("qwen3-1.7b").reduced(), \
        get_config("qwen3-1.7b").reduced()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    host = _host(rcfg, 21)
    tokens = np.random.default_rng(22).integers(
        0, rcfg.vocab_size, (8, 32)).astype(np.int32)
    rcfg_opt = ref_opt.AdamWConfig(**kw)
    rparams = jax.tree.map(jnp.asarray, host)
    rnew, rstate, rmet = jax.jit(ref_make_train_step(
        ref_build(rcfg), rcfg_opt, microbatch=4))(
        rparams, ref_opt.adamw_init(rparams, rcfg_opt),
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)})
    pcfg_opt = AdamWConfig(**kw)
    params = trainable(params_from_jax(host, "cpu"))
    t = torch.from_numpy(tokens)
    pnew, pstate, pmet = make_train_step(build_model(pcfg), pcfg_opt,
                                         microbatch=4)(
        params, opt.adamw_init(params, pcfg_opt), {"tokens": t, "labels": t})
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        want, got = float(rmet[k]), float(pmet[k])
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-6), \
            (k, got, want)
    for i, (want, got) in enumerate(zip(_np_leaves(rstate.m),
                                        tree_leaves(pstate.m))):
        err = float(np.abs(got.numpy() - want).max())
        assert err <= GRAD_TOL["dense"] * np.abs(want).max(), (i, err)
    assert_close_after_adamw(
        [(want, got.detach().numpy()) for want, got in
         zip(_np_leaves(rnew), tree_leaves(pnew))], kw["lr"])


def assert_close_after_adamw(pairs, lr_sum, tol=1e-4, loose=1e-4):
    """(reference, port) parameter leaves after a few AdamW steps from the
    same weights: every entry within tol of its leaf's largest |p| but
    for at most max(1, ``loose`` * n) of a leaf's n entries, and those
    within 2 * lr_sum. An update is m_hat / sqrt(v_hat), scale-free in
    g, so a grad error dg moves it by about dg / |g|: at an entry whose
    grad in some step lies near eps or near the two sides' grad error,
    the update may differ by its whole size (|u| <= 1 in the first
    steps). Such entries are rare; a fault in one leaf's grads or update
    moves most of that leaf. Returns the loose entries counted."""
    n_loose = 0
    for i, (want, got) in enumerate(pairs):
        diff = np.abs(got - want)
        assert (diff <= 2 * lr_sum).all(), (i, diff.max())
        n = int((diff > tol * np.abs(want).max()).sum())
        assert n <= max(1, loose * diff.size), (i, n, diff.size)
        n_loose += n
    return n_loose


def test_trainer_matches_reference_trainer(tmp_path):
    """Three steps of the port's Trainer and of the JAX Trainer from the
    same weights on the same batches; each side's checkpoint restores in
    the other's Trainer."""
    rcfg, pcfg = ref_config("qwen3-1.7b").reduced(), \
        get_config("qwen3-1.7b").reduced()
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    dc = DataConfig(vocab_size=rcfg.vocab_size, seq_len=32, batch_size=4,
                    seed=3)
    steps = 3
    rtr = RefTrainer(ref_build(rcfg), ref_opt.AdamWConfig(**kw),
                     ckpt_path=str(tmp_path / "ref.npz"), ckpt_every=steps,
                     log_every=1)
    rtr.init(seed=0)
    host = jax.tree.map(np.asarray, rtr.params)
    rtr.fit(batches(dc), steps=steps, verbose=False)
    ptr = Trainer(build_model(pcfg), AdamWConfig(**kw),
                  ckpt_path=str(tmp_path / "port.npz"), ckpt_every=steps,
                  log_every=1, device="cpu")
    ptr.init(params=params_from_jax(host, "cpu"))
    ptr.fit(batches(dc), steps=steps, verbose=False)

    assert [h["step"] for h in ptr.history] == [1, 2, 3]
    for rh, ph in zip(rtr.history, ptr.history):
        for k in ("loss", "ce", "aux", "lr", "grad_norm"):
            assert abs(ph[k] - rh[k]) <= 1e-5 * max(abs(rh[k]), 1e-6), \
                (k, ph[k], rh[k])
    lr_sum = sum(h["lr"] for h in rtr.history)
    assert_close_after_adamw(
        [(want, got.detach().numpy()) for want, got in
         zip(_np_leaves(rtr.params), tree_leaves(ptr.params))], lr_sum)

    # the JAX Trainer restores the port's checkpoint, and the port's
    # Trainer the reference's, bit for bit
    rtr.ckpt_path = str(tmp_path / "port.npz")
    assert rtr.restore() and rtr.step == steps
    for want, got in zip(tree_leaves(ptr.params),
                         _np_leaves(rtr.params)):
        assert np.array_equal(want.detach().numpy(), got)
    ptr.ckpt_path = str(tmp_path / "ref.npz")
    host_after = jax.tree.map(np.asarray,
                              ref_ckpt.restore(str(tmp_path / "ref.npz"),
                                               {"params": host})[0])
    assert ptr.restore() and ptr.step == steps
    for want, got in zip(_np_leaves(host_after["params"]),
                         tree_leaves(ptr.params)):
        assert got.requires_grad and np.array_equal(got.detach().numpy(),
                                                     want)
    ptr.ckpt_path = str(tmp_path / "missing.npz")
    assert not ptr.restore()


# --- checkpoints --------------------------------------------------------------

def _ref_state(dtype, seed):
    """{"params", "opt"} of reduced qwen3 in ``dtype``, with random
    moments and step 7, in the reference's types."""
    rcfg = ref_config("qwen3-1.7b").reduced()
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype),
                          _host(rcfg, seed))
    rng = np.random.default_rng(seed)
    rand = lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32)
    st = ref_opt.AdamWState(jnp.int32(7), jax.tree.map(rand, params),
                            jax.tree.map(rand, params))
    return {"params": params, "opt": st}


def _port_template(ref_state):
    """The same structure in the port's types, filled with zeros."""
    z = lambda a: torch.zeros(a.shape, dtype=getattr(torch, str(a.dtype)))
    return {"params": jax.tree.map(z, ref_state["params"]),
            "opt": opt.AdamWState(torch.zeros((), dtype=torch.int32),
                                  jax.tree.map(z, ref_state["opt"].m),
                                  jax.tree.map(z, ref_state["opt"].v))}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_bit_for_bit(tmp_path, dtype):
    state = _ref_state(getattr(jnp, dtype), 4)
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save(path, state, step=7)
    got, step = ckpt.restore(path, _port_template(state))
    assert step == 7 and int(got["opt"].step) == 7
    want_leaves = jax.tree.leaves(state)
    got_leaves = list(ckpt.keyed_leaves(got))
    assert len(want_leaves) == len(got_leaves)
    for want, (key, t) in zip(want_leaves, got_leaves):
        assert str(t.dtype) == f"torch.{np.asarray(want).dtype}", key
        tb = t.view(torch.int16).numpy().view(np.uint16) \
            if t.dtype == torch.bfloat16 else t.numpy()
        assert np.array_equal(tb, _bits(want)), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_matches_reference_format(tmp_path, dtype):
    state = _ref_state(getattr(jnp, dtype), 5)
    rpath, ppath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_ckpt.save(rpath, state, step=3)
    pstate = ckpt.restore(rpath, _port_template(state))[0]
    ckpt.save(ppath, pstate, step=3)
    with np.load(rpath) as r, np.load(ppath) as p:
        assert sorted(r.files) == sorted(p.files)
        assert "opt::.m::layers::wq" in p.files and "opt::.step" in p.files
        for k in r.files:
            assert r[k].dtype.itemsize == p[k].dtype.itemsize, k
            assert r[k].dtype.kind == p[k].dtype.kind, k
            assert np.array_equal(_bits(r[k]), _bits(p[k])), k
    # the port's own round trip, bf16 leaves by their bits
    again, step = ckpt.restore(ppath, _port_template(state))
    assert step == 3
    for (k, a), (_, b) in zip(ckpt.keyed_leaves(pstate),
                              ckpt.keyed_leaves(again)):
        assert a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8),
            b.reshape(-1).view(torch.uint8)), k
    if dtype == "float32":
        # the reference restores the port's file
        back, step = ref_ckpt.restore(ppath, state)
        assert step == 3
        for want, got in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
            assert np.array_equal(np.asarray(want), np.asarray(got))


# --- the autograd guard -------------------------------------------------------

def _wrapper_calls():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    B, S, H, KV, dh = 1, 8, 2, 1, 32
    q, k, v = r(B, S, H, dh), r(B, S, KV, dh), r(B, S, KV, dh)
    q1 = r(B, 1, H, dh)
    ck8 = torch.zeros(B, S, KV, dh, dtype=torch.int8)
    sc = torch.ones(B, S, KV)
    gates = r(B, S, H)
    x, dt, bc = r(B, S, H, 16), r(B, S, H).abs(), r(B, S, 8)
    return {
        "flash_attention": (fl.flash_attention, (q, k, v)),
        "decode_attention": (lambda q_: dec.decode_attention(q_, k, v, 3),
                             (q1,)),
        "decode_attention_quant": (
            lambda q_: dec.decode_attention_quant(q_, ck8, sc, ck8, sc, 3),
            (q1,)),
        "mlstm_scan": (lambda q_: k4.mlstm_scan(q_, q, q, gates, gates),
                       (q,)),
        "ssm_scan": (lambda x_: k5.ssm_scan(x_, dt, torch.zeros(H), bc, bc,
                                            torch.ones(H)), (x,)),
    }


@pytest.mark.parametrize("name", ["decode_attention",
                                  "decode_attention_quant",
                                  "flash_attention", "mlstm_scan",
                                  "ssm_scan"])
def test_kernel_wrappers_refuse_autograd(name):
    """A wrapper never returns a result detached from its inputs: with an
    input that requires grad under grad mode it raises, on every device;
    under no_grad it runs (here, on the CPU, its plain version)."""
    fn, args = _wrapper_calls()[name]
    args = tuple(a.clone().requires_grad_() for a in args)
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)
    with torch.no_grad():
        out = fn(*args)
    out = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(out).all()
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.refuse_autograd(name, torch.zeros(1),
                               torch.zeros(1, requires_grad=True))
    _build.refuse_autograd(name, torch.zeros(1), None, 3)


def test_training_through_the_kernels_raises():
    """The train forward with the kernel ops fails loudly; the model's
    loss_fn trains on the plain versions whatever its serving ops."""
    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    params = trainable(model.init_params(torch.Generator().manual_seed(0),
                                         "cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="requires grad"):
        port_tf.forward(cfg, params, tokens, ops=port_tf.KERNEL_OPS)
    loss, _ = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
    grads = torch.autograd.grad(loss, list(tree_leaves(params)))
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_time_chunks_match_one_scan():
    """The chunked, recomputed scan (S a multiple of 64 above it) gives
    the whole scan's outputs and gradients."""
    g = torch.Generator().manual_seed(2)
    B, S, H, dh = 1, 128, 2, 8
    ins = [torch.randn(B, S, H, dh, generator=g) for _ in range(3)] + \
        [torch.randn(B, S, H, generator=g) for _ in range(2)]
    ins = [t.requires_grad_() for t in ins]
    h1, st1 = common.time_chunks(k4.mlstm_scan_plain, ins, None)
    gr1 = torch.autograd.grad(h1.sum() + st1[0].sum(), ins)
    with torch.no_grad():
        h0, st0 = k4.mlstm_scan_plain(*ins)
    h2, st2 = k4.mlstm_scan_plain(*ins)
    gr2 = torch.autograd.grad(h2.sum() + st2[0].sum(), ins)
    assert torch.equal(h1, h0) and torch.equal(h1, h2)
    for a, b in zip(gr1, gr2):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_train_launcher_and_example_on_cpu(capsys):
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    last = train.main(["--device", "cpu", "--steps", "1", "--seq", "16",
                       "--batch", "2", "--layers", "1"])
    assert last["step"] == 1 and math.isfinite(last["loss"])
    with pytest.raises(AssertionError, match="did not learn"):
        train_lm.main(["--device", "cpu", "--steps", "2"])
    assert "final loss" in capsys.readouterr().out

