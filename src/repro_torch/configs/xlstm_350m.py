"""xLSTM-350M: alternating sLSTM + mLSTM blocks. [arXiv:2405.04517]

24 layers = 12 scanned (mLSTM, sLSTM) pair-blocks (DESIGN.md section 4).
d_ff=0: xLSTM blocks carry their own up/down projections
(proj factor 2.0 for mLSTM, 4/3 for sLSTM).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-350m", family="ssm",
    source="arXiv:2405.04517",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
)
