"""Granite-3.0 MoE 3B-A800M. [hf:ibm-granite/granite-3.0-1b-a400m-base]

Assignment line specifies both "MoE 40e top-8" (config field) and
"32 experts top-8" (note); we follow the explicit config field (40e).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    n_experts=40, top_k=8,
)
