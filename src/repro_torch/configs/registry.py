"""Architecture registry: ``--arch <id>`` -> ModelConfig.

One module per assigned architecture under repro_torch.configs; ids match the
assignment sheet exactly.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1p3b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "yi-9b": "repro_torch.configs.yi_9b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1p5_large",
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
}


def list_archs():
    return sorted(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    cfg: ModelConfig = mod.CONFIG
    assert cfg.arch_id == arch_id, (cfg.arch_id, arch_id)
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in list_archs()}
