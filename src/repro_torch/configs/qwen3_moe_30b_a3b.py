"""Qwen3-30B-A3B MoE. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b", family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936,
    n_experts=128, top_k=8,
    qk_norm=True, rope_theta=1_000_000.0,
)
