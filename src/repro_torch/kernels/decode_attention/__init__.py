from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_plain, decode_attention_quant,
    decode_attention_quant_plain)
