"""Qwen3-1.7B: qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-1.7b", family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
)
