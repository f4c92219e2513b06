"""Architecture registry: ``--arch <id>`` resolution for the port's entry points."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHITECTURES: dict[str, str] = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    # the paper's own simulated training model (Fig. 8)
    "paper-7b": "repro_torch.configs.paper_7b",
}


def _module(arch: str):
    if arch not in ARCHITECTURES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHITECTURES)}")
    return importlib.import_module(ARCHITECTURES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def list_architectures() -> list[str]:
    return sorted(ARCHITECTURES)
