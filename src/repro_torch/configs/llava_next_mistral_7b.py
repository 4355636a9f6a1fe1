"""LLaVA-NeXT (Mistral-7B backbone), anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

Transformer BACKBONE only: the SigLIP/CLIP vision tower + projector is
stubbed -- input_specs() provides precomputed patch embeddings
(anyres: 5 tiles x 576 patches = 2880) of shape (B, n_patches, d_model).
Mistral backbone has native sliding-window attention (4096).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b", family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    sliding_window=4096, n_patches=2880,
)
