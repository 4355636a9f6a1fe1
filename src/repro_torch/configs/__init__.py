"""Architecture config registry: ``get_config(arch_id)`` / ``--arch`` ids.

The port serves every decoder-only arch of ``repro.configs``: the dense
transformers, the MoE and VLM members of its family, Hymba and xLSTM.
Whisper (an encoder-decoder) is known here by name and raises, naming
the ROADMAP.md item (section 1, "Modules to port") that ports it.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen1.5-32b": "qwen1_5_32b",
    "deepseek-coder-33b": "deepseek_coder_33b",
}

_NOT_PORTED = {
    "whisper-large-v3": "item 9 (Whisper)",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet: "
            f"ROADMAP.md {_NOT_PORTED[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
