"""Model configurations the port serves: the dataclasses (a copy of the
reference's ``configs/base.py``) and the architectures it serves: the dense
GQA family, the Mamba-2 SSM and the Zamba2 hybrid."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).smoke_config()


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_smoke_config"]
