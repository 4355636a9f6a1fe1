"""Hymba-1.5B: parallel attention + Mamba heads per block, ssm_state=16.
[arXiv:2411.13676]

Simplifications vs the released model (see DESIGN.md): no meta tokens;
attention heads use a sliding window (Hymba uses SWA in all but 3
layers), making the arch natively long-context capable.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b", family="hybrid",
    source="arXiv:2411.13676",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_heads=25, ssm_head_dim=64,
    sliding_window=1024,
)
