"""Analytic FLOPs / HBM-bytes model per (arch, input shape).

Used by (a) the roofline report — XLA's cost_analysis counts a scanned
layer body once, so analytic counts are the primary compute/memory terms,
with HLO numbers reported alongside — and (b) the serving simulator's
service-time cost model.

Conventions: matmul (m,k)x(k,n) = 2mkn FLOPs. Backward = 2x forward
matmul FLOPs (the standard 6ND for training). Attention counted causally
(S^2/2). Bytes: weights streamed once per step + KV/state traffic +
activation traffic approximated at 4 bytes-per-FLOP/1000 ambient (small
next to weights/KV for the shapes here, reported separately).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.shapes import InputShape


@dataclass(frozen=True)
class CostTerms:
    flops: float           # total FLOPs for the step (global)
    weight_bytes: float    # parameter bytes touched
    kv_bytes: float        # KV-cache / recurrent-state traffic
    act_bytes: float       # activation HBM traffic estimate

    @property
    def hbm_bytes(self) -> float:
        return self.weight_bytes + self.kv_bytes + self.act_bytes


def _dtype_size(cfg: ModelConfig) -> int:
    return 2 if "16" in cfg.param_dtype else 4


def _attn_flops_layer(cfg: ModelConfig, B: float, Sq: float, Skv: float,
                      causal: bool) -> float:
    """QK^T + AV for one layer; causal halves the score area when Sq==Skv."""
    H, dh = cfg.n_heads, cfg.head_dim
    area = Sq * Skv * (0.5 if (causal and Sq == Skv) else 1.0)
    return 4.0 * B * H * dh * area


def _window_ctx(cfg: ModelConfig, S: int) -> float:
    w = cfg.sliding_window or (
        cfg.long_context_window if S > 65_536 else 0)
    return min(S, w) if w else S


def step_cost(cfg: ModelConfig, shape: InputShape) -> CostTerms:
    B, S = shape.global_batch, shape.seq_len
    ds = _dtype_size(cfg)
    N_active = cfg.n_active_params()
    N_total = cfg.n_params()
    L, KV, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    if shape.kind == "train":
        tokens = B * S
        mm = 6.0 * N_active * tokens
        ctx = _window_ctx(cfg, S)
        att = 3.0 * L * _attn_flops_layer(cfg, B, S, ctx, causal=True)
        if cfg.family == "audio":
            att += 3.0 * cfg.n_encoder_layers * _attn_flops_layer(
                cfg, B, cfg.encoder_len, cfg.encoder_len, causal=False)
            att += 3.0 * L * _attn_flops_layer(
                cfg, B, S, cfg.encoder_len, causal=False)
        # params + grads + adam m,v touched (bf16 params, f32 opt: ~10x)
        wbytes = N_total * (ds + 4 + 8)
        act = 4.0 * tokens * cfg.d_model * L * ds  # saved carries + remat
        return CostTerms(mm + att, wbytes, 0.0, act)

    if shape.kind == "prefill":
        tokens = B * S
        mm = 2.0 * N_active * tokens
        ctx = _window_ctx(cfg, S)
        att = L * _attn_flops_layer(cfg, B, S, ctx, causal=True)
        if cfg.family == "audio":
            att += cfg.n_encoder_layers * _attn_flops_layer(
                cfg, B, cfg.encoder_len, cfg.encoder_len, causal=False)
            att += L * _attn_flops_layer(cfg, B, S, cfg.encoder_len,
                                         causal=False)
        kvb = 2.0 * L * B * min(S, _window_ctx(cfg, S)) * KV * dh * ds
        act = 2.0 * tokens * cfg.d_model * L * ds
        return CostTerms(mm + att, N_active * ds, kvb, act)

    # decode: ONE token per sequence against a cache of length S
    tokens = B
    if cfg.family == "ssm":
        # state-recurrent: no KV, state traffic instead
        dm = int(cfg.mlstm_proj_factor * cfg.d_model)
        state = B * cfg.n_heads * (dm // cfg.n_heads) ** 2 * 4
        state_bytes = 2.0 * (cfg.n_layers // 2) * state
        mm = 2.0 * N_active * tokens
        return CostTerms(mm, N_active * ds, state_bytes,
                         2 * B * cfg.d_model * cfg.n_layers * ds)
    ctx = _window_ctx(cfg, S)
    mm = 2.0 * N_active * tokens
    att = L * _attn_flops_layer(cfg, B, 1, ctx, causal=False)
    # read full (windowed) cache; int8 KV (§Perf H5) reads 1 byte/elem
    # + one f32 scale per (token, kv-head)
    kv_elem = (1.0 + 4.0 / dh) if cfg.kv_quant else float(ds)
    kvb = 2.0 * L * B * ctx * KV * dh * kv_elem
    if cfg.family == "audio":
        att += L * _attn_flops_layer(cfg, B, 1, cfg.encoder_len,
                                     causal=False)
        kvb += 2.0 * L * B * cfg.encoder_len * cfg.n_heads * dh * ds
    if cfg.family == "hybrid":
        state = B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        kvb += 2.0 * L * state
    # MoE decode touches min(E, tokens*k) experts' weights
    wbytes = N_active * ds
    if cfg.is_moe:
        per_expert = 3 * cfg.d_model * cfg.d_ff * ds
        touched = min(cfg.n_experts, tokens * cfg.top_k)
        base = (N_active - cfg.n_layers * cfg.top_k
                * 3 * cfg.d_model * cfg.d_ff) * ds
        wbytes = base + cfg.n_layers * touched * per_expert
    act = 2 * B * cfg.d_model * L * ds
    return CostTerms(mm + att, wbytes, kvb, act)


# --- hardware (NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU
# datasheet) -------------------------------------------------------------------
PEAK_FLOPS = 989e12        # dense bf16 tensor-core peak per card
HBM_BW = 3.35e12           # HBM3 bytes/s per card
# NVLink 4: 900 GB/s per card over its 18 links, both directions together;
# the roofline's interconnect term is the aggregate over the links in one
# direction (the name is the reference's, kept so the rest stays its text)
ICI_BW = 450e9             # bytes/s per card, per direction, all links


def roofline_terms(cost: CostTerms, chips: int,
                   collective_bytes: float = 0.0):
    """Three roofline terms in seconds (global work / aggregate capability)."""
    compute = cost.flops / (chips * PEAK_FLOPS)
    memory = cost.hbm_bytes / (chips * HBM_BW)
    collective = collective_bytes / (chips * ICI_BW)
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective,
            "dominant": max((("compute", compute), ("memory", memory),
                             ("collective", collective)),
                            key=lambda kv: kv[1])[0]}
