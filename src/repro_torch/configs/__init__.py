"""Architecture config registry: ``get_config(arch_id)`` / ``--arch`` ids."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-1.7b": "qwen3_1_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "qwen1.5-32b": "qwen1_5_32b",
    "whisper-large-v3": "whisper_large_v3",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
