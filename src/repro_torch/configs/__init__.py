"""Architecture registry: the 10 assigned archs + shapes + the modelled
fleet's parameters (data only). A copy of ``src/repro/configs``."""
from __future__ import annotations

import importlib

from .base import (FLEET, SHAPES, FleetConfig, ModelConfig, MoEConfig,
                   ShapeSpec, SSMConfig, applicable)

# arch-id -> module name in this package
_ARCH_MODULES: dict[str, str] = {
    "granite-3-2b": "granite_3_2b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "yi-6b": "yi_6b",
    "qwen3-0.6b": "qwen3_0_6b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "zamba2-7b": "zamba2_7b",
    "internvl2-26b": "internvl2_26b",
    "mamba2-370m": "mamba2_370m",
    "whisper-tiny": "whisper_tiny",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f".{_ARCH_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


__all__ = [
    "ARCH_IDS", "FLEET", "SHAPES", "FleetConfig", "ModelConfig", "MoEConfig",
    "ShapeSpec", "SSMConfig", "applicable", "get_config", "get_smoke_config",
]
