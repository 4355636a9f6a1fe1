"""Model/architecture configuration for all assigned architectures.

Every config cites its source (HF model card or arXiv) in ``source``.
``reduced()`` produces the smoke-test variant (<=2 layers, d_model<=512,
<=4 experts) of the same family, per the deliverable spec.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""

    # transformer backbone
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention options
    qk_norm: bool = False          # qwen3 family
    qkv_bias: bool = False         # qwen1.5 family
    rope_2d: bool = False          # chatglm: rope on half of head_dim
    sliding_window: int = 0        # 0 = full attention; >0 native SWA (mistral)
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0             # mamba state size N (hymba)
    ssm_heads: int = 0             # number of SSM heads (hybrid)
    ssm_head_dim: int = 0
    conv_width: int = 4

    # xLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_len: int = 1500        # whisper: 30s audio -> 1500 frames post-conv
    max_positions: int = 32768     # learned decoder position table (whisper;
                                   # extended past the published 448, see config)

    # VLM
    n_patches: int = 0             # llava-next anyres: patches fed as embeddings

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    kv_quant: bool = False         # int8 KV cache + per-(token,head) scales
                                   # (beyond-paper, §Perf H5; decode shapes)

    # long-context decode: ring-buffer window used ONLY for the long_500k
    # shape on archs without native sub-quadratic attention (beyond-paper
    # variant, see DESIGN.md).
    long_context_window: int = 8192

    # training
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
            f"{self.arch_id}: n_heads {self.n_heads} not divisible by "
            f"n_kv_heads {self.n_kv_heads}")

    # -- derived -----------------------------------------------------------
    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """True if the arch can run long_500k (sub-quadratic path exists)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window > 0:
            return True
        if self.family == "audio":
            return False  # whisper decoder positionally bounded (448)
        # dense/moe: beyond-paper ring-buffer SWA decode variant
        return True

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, dh = self.d_model, self.head_dim
        H, KV, L = self.n_heads, self.n_kv_heads, self.n_layers
        attn = d * (H * dh) + 2 * d * (KV * dh) + (H * dh) * d
        if self.qkv_bias:
            attn += (H + 2 * KV) * dh
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        elif self.family == "ssm":
            # xlstm pair block (mLSTM + sLSTM), see models/xlstm.py
            dm = int(self.mlstm_proj_factor * d)
            mlstm = d * 2 * dm + 3 * dm * dm + 2 * dm * H + dm * d
            ds = d
            dsf = int(self.slstm_proj_factor * d)
            slstm = 4 * d * ds + 4 * ds * ds + d * dsf * 2 + dsf * d
            return self.vocab_size * d + (L // 2) * (mlstm + slstm)
        else:
            ffn = 3 * d * self.d_ff
        if self.family == "hybrid":
            di = self.ssm_heads * self.ssm_head_dim
            ssm = d * di + di * self.conv_width + 2 * d * self.ssm_state \
                + d * self.ssm_heads + 2 * self.ssm_heads + di * d
            ffn += ssm
        per_layer = attn + ffn + 2 * d
        total = L * per_layer + self.vocab_size * d + d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
            total += L * (attn + d)  # decoder cross-attention
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        dense_ffn = self.n_experts * 3 * d * self.d_ff
        active_ffn = self.top_k * 3 * d * self.d_ff
        return self.n_params() - self.n_layers * (dense_ffn - active_ffn)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/features, tiny dims."""
        d = min(self.d_model, 256)
        H = min(self.n_heads, 4)
        KV = max(1, min(self.n_kv_heads, H))
        while H % KV:
            KV -= 1
        kw = dict(
            n_layers=2, d_model=d, n_heads=H, n_kv_heads=KV,
            head_dim=d // H, d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32", param_dtype="float32",
            long_context_window=64,
        )
        if self.is_moe:
            kw.update(n_experts=4, top_k=2, d_ff=min(self.d_ff, 128))
        if self.family == "hybrid":
            kw.update(ssm_heads=min(self.ssm_heads, 2), ssm_head_dim=32,
                      ssm_state=min(self.ssm_state, 8))
        if self.n_encoder_layers:
            kw.update(n_encoder_layers=2, encoder_len=32, max_positions=128)
        if self.n_patches:
            kw.update(n_patches=8)
        return dataclasses.replace(self, **kw)
