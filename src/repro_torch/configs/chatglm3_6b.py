"""ChatGLM3-6B: RoPE-2d (half head_dim), GQA kv=2. [arXiv:2406.12793]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chatglm3-6b", family="dense",
    source="arXiv:2406.12793",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    rope_2d=True,
)
