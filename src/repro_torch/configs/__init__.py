"""Architecture config registry: ``get_config(arch_id)`` / ``--arch`` ids.

The port serves the dense transformer, Hymba and xLSTM so far. The
other archs of ``repro.configs`` are known here by name and raise, naming
the ROADMAP.md item (section 1, "Modules to port") that ports each one.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
}

_NOT_PORTED = {
    "qwen3-moe-30b-a3b": "item 8 (MoE)",
    "granite-moe-3b-a800m": "item 8 (MoE)",
    "whisper-large-v3": "item 9 (Whisper)",
    "llava-next-mistral-7b": "item 10 (VLM and the other dense configs)",
    "chatglm3-6b": "item 10 (VLM and the other dense configs)",
    "qwen1.5-32b": "item 10 (VLM and the other dense configs)",
    "deepseek-coder-33b": "item 10 (VLM and the other dense configs)",
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
