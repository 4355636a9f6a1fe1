"""xLSTM full-model stack over (mLSTM, sLSTM) pair blocks (port of
``repro.models.xlstm_stack``).

The recurrent state (C, n, m / c, n, m, h) *is* the serve cache: decode
cost is independent of context length. A Python loop over the P pair
blocks takes the place of ``jax.lax.scan``, slicing the stacked leading-P
parameters and state (``common.unstack``); while autograd records, each
pair block is recomputed in the backward (``common.remat``), as the
reference's training forward does. Each step returns a fresh state; the
one it was given is not written.

Under a mesh each pair block runs on the local batch shard with its
weights gathered (``shardctx.batch_local``): DTensor has no sharding rule
for the sLSTM's log-sigmoid, and the mLSTM scan kernel takes local
tensors. Embedding, carry and logits keep the reference's constraints.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import xlstm
from repro_torch.models.common import remat, rms_norm, unstack
from repro_torch.utils.shardctx import (P, batch_axis, batch_local, home,
                                        local_layout, maybe_shard, zeros)
from repro_torch.models.xlstm import KERNEL_SCAN_OPS, PLAIN_SCAN_OPS, ScanOps


def param_table(cfg: ModelConfig) -> Dict:
    return xlstm.xlstm_param_table(cfg)


def state_shapes(cfg: ModelConfig, batch: int) -> Dict:
    """Nested dict of (shape, dtype) with leading pair-block dim P."""
    n_pairs = cfg.n_layers // 2
    per = xlstm.pair_state_shapes(cfg, batch)
    return {half: {k: ((n_pairs,) + s, d) for k, (s, d) in leaves.items()}
            for half, leaves in per.items()}


def zero_state(cfg: ModelConfig, batch: int, device) -> Dict:
    """Zero state leaves on ``device``; under a mesh, when ``device`` is
    a DeviceMesh, DTensors split by batch."""
    b, _ = local_layout(batch, 1)
    return {half: {k: zeros(s, d, device, P(None, b))
                   for k, (s, d) in leaves.items()}
            for half, leaves in state_shapes(cfg, batch).items()}


def _stack(trees) -> Dict:
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


def _run(cfg: ModelConfig, params, tokens, state, ops: ScanOps,
         last_only: bool):
    x = F.embedding(tokens.long(), params["emb"]).to(cfg.compute_dtype)
    x = maybe_shard(x, batch_axis())
    n_pairs = cfg.n_layers // 2
    new = []
    for p, st in zip(unstack(params["pairs"], n_pairs),
                     unstack(state, n_pairs)):
        x = maybe_shard(x, batch_axis(), "model")  # sequence-parallel carry
        x, st = remat(_pair, cfg, p, x, st, ops)
        new.append(st)
    if last_only:
        # only the last position's logits are returned: the reference
        # computes all of them and keeps that one
        x = x[:, -1:]
    x = maybe_shard(rms_norm(x, params["final_norm"]), batch_axis())
    logits = x @ params["lm_head"].to(x.dtype)
    return maybe_shard(logits, batch_axis(), None, "model"), _stack(new)


def _pair(cfg: ModelConfig, p, x, st, ops: ScanOps):
    """``xlstm.pair_apply``, on the local batch shard under a mesh
    (``shardctx.batch_local``)."""
    keys = [(h, k) for h in st for k in st[h]]

    def local(p, x, *flat):
        pair_state = {}
        for (h, k), t in zip(keys, flat):
            pair_state.setdefault(h, {})[k] = t
        y, new = xlstm.pair_apply(cfg, p, x, pair_state, ops)
        return (y, *(new[h][k] for h, k in keys))

    y, *flat = batch_local(local, p, (x, *(st[h][k] for h, k in keys)),
                           1 + len(keys))
    new = {}
    for (h, k), t in zip(keys, flat):
        new.setdefault(h, {})[k] = t
    return y, new


    return logits, _stack(new)


def forward(cfg: ModelConfig, params, tokens,
            ops: ScanOps = PLAIN_SCAN_OPS):
    """Teacher-forced logits (B, S, vocab) from the zero state, and the
    reference's zero aux loss: the training forward, each pair block
    recomputed in the backward (``common.remat``)."""
    state = zero_state(cfg, tokens.shape[0], home(tokens))
    logits, _ = _run(cfg, params, tokens, state, ops, last_only=False)
    return logits, torch.zeros((), device=logits.device)


def prefill(cfg: ModelConfig, params, tokens,
            ops: ScanOps = KERNEL_SCAN_OPS):
    """Run the prompt from the zero state; return (last-position logits,
    state)."""
    state = zero_state(cfg, tokens.shape[0], home(tokens))
    logits, state = _run(cfg, params, tokens, state, ops, last_only=True)
    return logits[:, -1], state


def decode_step(cfg: ModelConfig, params, state, tokens, pos,
                ops: ScanOps = KERNEL_SCAN_OPS):
    """One serve step: tokens (B,1). ``pos`` is ignored, as in the
    reference: the state carries the position."""
    logits, state = _run(cfg, params, tokens, state, ops, last_only=False)
    return logits[:, 0], state
