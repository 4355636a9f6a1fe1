"""Whisper-large-v3 enc-dec backbone. [arXiv:2212.04356]

Conv/mel frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, 1500, d_model). 32L is interpreted as 32 encoder + 32
decoder layers (the published large-v3 layout). Decoder positions are
learned; the position table is sized to the requested decode length
(noted extension -- published max is 448). long_500k is SKIPPED for this
arch (DESIGN.md section 4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3", family="audio",
    source="arXiv:2212.04356",
    n_layers=32, n_encoder_layers=32, encoder_len=1500,
    d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866,
)
