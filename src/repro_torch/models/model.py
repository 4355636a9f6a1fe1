"""Model API over the ported families (port of ``repro.models.model``).

``build_model(cfg)`` returns a ``Model`` exposing:
  - ``init_params(generator, device)``           (parameters on a device)
  - ``prefill_fn(params, batch)``                (prompt -> cache)
  - ``decode_fn(params, cache, tokens, pos)``    (serve_step)
  - cache/batch shape planning per input shape
The dense family, the hybrid family (Hymba: attention and SSM heads in
each block, whose cache adds the SSM and conv states to the ring kv
cache) and xLSTM (``family == "ssm"``, whose cache is its recurrent state)
are ported; the others raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, transformer, xlstm, xlstm_stack
from repro_torch.shapes import InputShape


@dataclass(frozen=True)
class CachePlan:
    kind: str        # "full" | "ring" | "state"
    length: int      # kv slots (0 for pure-state archs)

    @property
    def ring(self) -> bool:
        return self.kind == "ring"


def decode_cache_plan(cfg: ModelConfig, seq_len: int) -> CachePlan:
    if cfg.family == "ssm":
        return CachePlan("state", 0)
    if cfg.sliding_window:
        w = min(cfg.sliding_window, seq_len)
        return CachePlan("ring", w)
    if seq_len > 65_536:
        # beyond-paper sub-quadratic variant for dense archs (DESIGN.md)
        return CachePlan("ring", cfg.long_context_window)
    return CachePlan("full", seq_len)


@dataclass
class Model:
    cfg: ModelConfig
    param_table: Any
    ops: transformer.BlockOps = transformer.KERNEL_OPS
    scan_ops: xlstm.ScanOps = xlstm.KERNEL_SCAN_OPS

    @property
    def stateful(self) -> bool:
        """The cache is the recurrent state (xLSTM)."""
        return self.cfg.family == "ssm"

    # -- parameters ------------------------------------------------------
    def init_params(self, generator: torch.Generator, device) -> Dict:
        return common.init_params(self.param_table, self.cfg, generator,
                                  device)

    # -- steps ------------------------------------------------------------
    def prefill_fn(self, params, batch, cache_len=None, ring=False):
        if self.stateful:
            return xlstm_stack.prefill(self.cfg, params, batch["tokens"],
                                       ops=self.scan_ops)
        return transformer.prefill(self.cfg, params, batch["tokens"],
                                   cache_len=cache_len, ring=ring,
                                   ops=self.ops)

    def decode_fn(self, params, cache, tokens, pos, ring=False):
        if self.stateful:
            return xlstm_stack.decode_step(self.cfg, params, cache, tokens,
                                           pos, ops=self.scan_ops)
        return transformer.decode_step(self.cfg, params, cache, tokens, pos,
                                       ring=ring, ops=self.ops)

    # -- shapes -----------------------------------------------------------
    def cache_shapes(self, batch: int, plan: CachePlan):
        if self.stateful:
            return xlstm_stack.state_shapes(self.cfg, batch)
        return transformer.cache_shapes(self.cfg, batch, plan.length,
                                        plan.ring)

    def zero_cache(self, batch: int, plan: CachePlan, device) -> Dict:
        if self.stateful:
            return xlstm_stack.zero_state(self.cfg, batch, device)
        return transformer.zero_cache(self.cfg, batch, plan.length,
                                      plan.ring, device)

    def batch_shapes(self, shape: InputShape) -> Dict[str, Tuple]:
        """Input tensor shapes/dtypes for a given input shape."""
        B, S = shape.global_batch, shape.seq_len
        itok = torch.int32
        if shape.kind == "decode":
            return {"tokens": ((B, 1), itok)}
        out: Dict[str, Tuple] = {"tokens": ((B, S), itok)}
        if shape.kind == "train":
            out["labels"] = ((B, S), itok)
        return out

    def make_batch(self, shape: InputShape, generator: torch.Generator,
                   device) -> Dict:
        """Random inputs on ``device``, drawn from ``generator`` (on the
        same device): token ids uniform in [0, vocab)."""
        out = {}
        for k, (s, d) in self.batch_shapes(shape).items():
            out[k] = torch.randint(0, self.cfg.vocab_size, s,
                                   generator=generator, dtype=d,
                                   device=device)
        return out


def build_model(cfg: ModelConfig,
                ops: transformer.BlockOps = transformer.KERNEL_OPS,
                scan_ops: xlstm.ScanOps = xlstm.KERNEL_SCAN_OPS) -> Model:
    """A dense-family, hybrid or xLSTM model; ``ops`` picks the
    transformer block's kernels, attention and the hybrid block's SSM scan
    (``transformer.KERNEL_OPS`` or ``PLAIN_OPS``), and ``scan_ops`` the
    mLSTM scan's (``xlstm.KERNEL_SCAN_OPS`` or ``PLAIN_SCAN_OPS``)."""
    if cfg.family == "ssm":
        return Model(cfg, xlstm_stack.param_table(cfg), ops, scan_ops)
    return Model(cfg, transformer.decoder_param_table(cfg), ops, scan_ops)
