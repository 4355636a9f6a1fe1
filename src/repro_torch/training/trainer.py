"""Training loop: the train step (loss, grads by autograd, AdamW), its
microbatches, periodic logging and checkpointing (port of
``repro.training.trainer``).

Parameters are leaf tensors that require grad, set so by the ``Trainer``
(``trainable``), not by ``Model.init_params``, whose tensors serve. The
model's loss runs the plain versions of the kernels (they are
forward-only), with each block recomputed in the backward.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.model import Model
from repro_torch.runtime.device import resolve_device
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)
from repro_torch.utils import shardctx


def trainable(params):
    """A copy of ``params`` as leaf tensors that require grad (the train
    step updates them in place)."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(), params)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatch: int = 1, grad_sharding=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the parameters and the optimizer's moments are updated in
    place (``adamw_update``).

    microbatch=K > 1 splits the batch into K contiguous chunks along dim
    0, accumulates their grads in float32 and divides by K; loss and
    metrics are the means over the chunks. Under a mesh each chunk is
    sharded over the data axes again. ``grad_sharding`` (a tree of ``P``
    matching params, the ZeRO-1 specs of ``launch.specs.zero1_shardings``)
    pins each chunk's grads and the float32 accumulator to that layout:
    the grads' all-reduce over the data axes becomes a reduce-scatter and
    the accumulator is stored sharded over them (ZeRO-2, §Perf H4); it is
    also passed on to ``adamw_update``. Without DTensor parameters it
    changes nothing."""
    K = microbatch
    specs = None if grad_sharding is None else list(tree_leaves(grad_sharding))

    def constrain(gs):
        if specs is None:
            return list(gs)
        return [shardctx.constrain(g, s) for g, s in zip(gs, specs)]

    def grads_of(params, leaves, batch):
        loss, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state: AdamWState, batch):
        leaves = list(tree_leaves(params))
        if K == 1:
            loss, metrics, grads = grads_of(params, leaves, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % K:
                raise ValueError(f"make_train_step: batch {B} does not "
                                 f"split into {K} microbatches")
            n = B // K
            grads = constrain(torch.zeros_like(p, dtype=torch.float32)
                              for p in leaves)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            ms = []
            for i in range(K):
                chunk = {k: shardctx.maybe_shard(v[i * n:(i + 1) * n],
                                                 shardctx.batch_axis())
                         for k, v in batch.items()}
                l_i, m_i, g_i = grads_of(params, leaves, chunk)
                # pin the chunk grads to the accumulator's (ZeRO) layout
                g_i = constrain(g_i)
                with torch.no_grad():
                    for a, g in zip(grads, g_i):
                        a.add_(g.float())
                del g_i
                loss = loss + l_i
                ms.append(m_i)
            with torch.no_grad():
                for a in grads:
                    a.div_(K)
            loss = loss / K
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        # grads: a list in tree_leaves(params) order
        params, opt_state, opt_metrics = adamw_update(
            list(grads), opt_state, params, opt_cfg, shardings=grad_sharding)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)
    return train_step


@dataclass
class Trainer:
    model: Model
    opt_cfg: AdamWConfig
    ckpt_path: Optional[str] = None
    ckpt_every: int = 200
    log_every: int = 20
    microbatch: int = 1
    device: Any = "cuda"

    params: Any = None
    opt_state: Optional[AdamWState] = None
    step: int = 0
    history: list = field(default_factory=list)

    def init(self, seed: int = 0, params=None) -> None:
        """Parameters drawn by the model's ``init_params`` from a
        generator seeded with ``seed`` on ``device`` (or ``params``,
        copied to ``device``), and a fresh optimizer state. Raises if
        ``device`` is a CUDA device and CUDA is not available."""
        dev = resolve_device(self.device)
        if params is None:
            params = self.model.init_params(
                torch.Generator(dev).manual_seed(seed), dev)
        self.params = trainable(tree_map(lambda t: t.to(dev), params))
        del params    # the drawn copy goes before the moments are made
        self.opt_state = adamw_init(self.params, self.opt_cfg)
        self._step_fn = make_train_step(self.model, self.opt_cfg,
                                        self.microbatch)

    def restore(self) -> bool:
        try:
            state = {"params": self.params, "opt": self.opt_state}
            state, self.step = ckpt.restore(self.ckpt_path, state)
        except (FileNotFoundError, KeyError):
            return False
        # fresh tensors from the file: leaves already, no copy needed
        self.params = tree_map(lambda t: t.requires_grad_(), state["params"])
        self.opt_state = state["opt"]
        return True

    def fit(self, data: Iterator[Dict[str, np.ndarray]], steps: int,
            verbose: bool = True) -> Dict[str, float]:
        """``steps`` train steps on batches of numpy arrays from ``data``.
        Every ``log_every`` steps (and at step 1) the metrics are read
        into ``history``, with ``steps_per_s`` over the steps of this
        call; a checkpoint every ``ckpt_every`` steps."""
        assert self.params is not None, "call init() first"
        dev = self.opt_state.step.device
        t0 = time.monotonic()
        last = {}
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(data).items()}
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % self.log_every == 0 or self.step == 1:
                last = {k: float(v) for k, v in metrics.items()}
                last["step"] = self.step
                last["steps_per_s"] = (i + 1) / (time.monotonic() - t0)
                self.history.append(last)
                if verbose:
                    print(f"step {self.step:5d} loss={last['loss']:.4f} "
                          f"lr={last['lr']:.2e} "
                          f"gnorm={last['grad_norm']:.2f}")
            if self.ckpt_path and self.step % self.ckpt_every == 0:
                ckpt.save(self.ckpt_path,
                          {"params": self.params, "opt": self.opt_state},
                          self.step)
        return last
