"""Model API over the ported families (port of ``repro.models.model``).

``build_model(cfg)`` returns a ``Model`` exposing:
  - parameter views (``abstract_params``: meta tensors;
    ``init_params(generator, device)``; ``partition_specs(mesh)``)
  - ``loss_fn(params, batch)``                   (training)
  - ``prefill_fn(params, batch)``                (prompt -> cache)
  - ``decode_fn(params, cache, tokens, pos)``    (serve_step)
  - cache/batch shape planning per input shape
The dense family, MoE (an expert FFN in each block), the VLM (a prompt
of patch embeddings, then tokens), the hybrid family (Hymba: attention
and SSM heads in each block, whose cache adds the SSM and conv states to
the ring kv cache), xLSTM (``family == "ssm"``, whose cache is its
recurrent state) and Whisper (``family == "audio"``: a batch of frame
embeddings, then the decoder prompt; a self and a cross kv cache) are
ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, transformer, whisper, xlstm, \
    xlstm_stack
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

    @property
    def audio(self) -> bool:
        """An encoder-decoder over frame embeddings (Whisper)."""
        return self.cfg.family == "audio"

    # -- parameters ------------------------------------------------------
    def abstract_params(self) -> Dict:
        return common.abstract_params(self.param_table, self.cfg)

    def init_params(self, generator: torch.Generator, device) -> Dict:
        return common.init_params(self.param_table, self.cfg, generator,
                                  device)

    def partition_specs(self, mesh) -> Dict:
        return common.partition_specs(self.param_table, mesh)

    # -- steps ------------------------------------------------------------
    def loss_fn(self, params, batch):
        """(loss, {"ce", "aux"}) of a batch with ``labels``, as the
        reference's ``_tf_loss``, ``_whisper_loss`` and ``_xlstm_loss``:
        the next-token CE of the logits, plus 0.01 * the MoE aux loss for
        the transformer families (a VLM's patch positions dropped first).
        The kernels are forward-only, so this runs the plain versions
        (``transformer.PLAIN_OPS``, ``xlstm.PLAIN_SCAN_OPS``) whatever
        ``ops`` the model serves with."""
        cfg, tokens = self.cfg, batch["tokens"]
        if self.stateful:
            logits, aux = xlstm_stack.forward(cfg, params, tokens,
                                              xlstm.PLAIN_SCAN_OPS)
        elif self.audio:
            logits, aux = whisper.forward(cfg, params, tokens,
                                          batch["frames"],
                                          transformer.PLAIN_OPS)
        else:
            pe = batch.get("patch_embeds")
            logits, aux = transformer.forward(cfg, params, tokens, pe,
                                              transformer.PLAIN_OPS)
            if pe is not None:
                logits = logits[:, pe.shape[1]:]
        ce = common.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
        loss = ce if self.stateful or self.audio else ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}

    def prefill_fn(self, params, batch, cache_len=None, ring=False):
        if self.stateful:
            return xlstm_stack.prefill(self.cfg, params, batch["tokens"],
                                       ops=self.scan_ops)
        if self.audio:
            return whisper.prefill(self.cfg, params, batch["tokens"],
                                   batch["frames"], cache_len=cache_len,
                                   ops=self.ops)
        return transformer.prefill(self.cfg, params, batch["tokens"],
                                   patch_embeds=batch.get("patch_embeds"),
                                   cache_len=cache_len, ring=ring,
                                   ops=self.ops)

    def decode_fn(self, params, cache, tokens, pos, ring=False):
        if self.stateful:
            return xlstm_stack.decode_step(self.cfg, params, cache, tokens,
                                           pos, ops=self.scan_ops)
        if self.audio:
            return whisper.decode_step(self.cfg, params, cache, tokens, pos,
                                       ops=self.ops)
        return transformer.decode_step(self.cfg, params, cache, tokens, pos,
                                       ring=ring, ops=self.ops)

    # -- shapes -----------------------------------------------------------
    def cache_shapes(self, batch: int, plan: CachePlan):
        if self.stateful:
            return xlstm_stack.state_shapes(self.cfg, batch)
        if self.audio:
            return whisper.cache_shapes(self.cfg, batch, plan.length)
        return transformer.cache_shapes(self.cfg, batch, plan.length,
                                        plan.ring)

    def zero_cache(self, batch: int, plan: CachePlan, device) -> Dict:
        if self.stateful:
            return xlstm_stack.zero_state(self.cfg, batch, device)
        if self.audio:
            return whisper.zero_cache(self.cfg, batch, plan.length, device)
        return transformer.zero_cache(self.cfg, batch, plan.length,
                                      plan.ring, device)

    def batch_shapes(self, shape: InputShape) -> Dict[str, Tuple]:
        """Input tensor shapes/dtypes for a given input shape: a VLM's
        ``seq_len`` counts its ``n_patches`` patch embeddings, which come
        before its tokens; Whisper's ``frames`` (B, encoder_len, d_model)
        come before its tokens and are not counted."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        itok = torch.int32
        if shape.kind == "decode":
            return {"tokens": ((B, 1), itok)}
        out: Dict[str, Tuple] = {}
        s_text = S
        if cfg.family == "vlm":
            s_text = S - cfg.n_patches
            out["patch_embeds"] = ((B, cfg.n_patches, cfg.d_model),
                                   cfg.compute_dtype)
        if cfg.family == "audio":
            out["frames"] = ((B, cfg.encoder_len, cfg.d_model),
                             cfg.compute_dtype)
        out["tokens"] = ((B, s_text), itok)
        if shape.kind == "train":
            out["labels"] = ((B, s_text), itok)
        return out

    def make_batch(self, shape: InputShape, generator: torch.Generator,
                   device) -> Dict:
        """Random inputs on ``device``, drawn from ``generator`` (on the
        same device) in ``batch_shapes``' order: token ids uniform in
        [0, vocab), patch embeddings and frames N(0, 1) * 0.02 in float32
        cast to the compute dtype."""
        out = {}
        for k, (s, d) in self.batch_shapes(shape).items():
            if d.is_floating_point:
                out[k] = (torch.randn(s, generator=generator,
                                      dtype=torch.float32, device=device)
                          * 0.02).to(d)
            else:
                out[k] = torch.randint(0, self.cfg.vocab_size, s,
                                       generator=generator, dtype=d,
                                       device=device)
        return out

    def decode_start(self, batch) -> int:
        """The position of the first decode step after a prefill of
        ``batch``: its tokens, and a VLM's patch embeddings before them
        (``repro/runtime/device.py:89-90``); Whisper's frames go to the
        encoder and shift no decoder position."""
        pos = batch["tokens"].shape[1]
        if "patch_embeds" in batch:
            pos += batch["patch_embeds"].shape[1]
        return pos


def build_model(cfg: ModelConfig,
                ops: transformer.BlockOps = transformer.KERNEL_OPS,
                scan_ops: xlstm.ScanOps = xlstm.KERNEL_SCAN_OPS) -> Model:
    """A dense, MoE, VLM, hybrid, xLSTM or Whisper model; ``ops`` picks
    the attention kernels of a transformer or Whisper block and the hybrid
    block's SSM scan (``transformer.KERNEL_OPS`` or ``PLAIN_OPS``), and
    ``scan_ops`` the mLSTM scan's (``xlstm.KERNEL_SCAN_OPS`` or
    ``PLAIN_SCAN_OPS``)."""
    if cfg.family == "ssm":
        return Model(cfg, xlstm_stack.param_table(cfg), ops, scan_ops)
    if cfg.family == "audio":
        return Model(cfg, whisper.whisper_param_table(cfg), ops, scan_ops)
    return Model(cfg, transformer.decoder_param_table(cfg), ops, scan_ops)
