# Verbatim copy of repro/configs/__init__.py (the JAX package's original); only import paths may differ.
"""Architecture registry: --arch <id> resolves here."""
from __future__ import annotations

from .base import ArchConfig, InputShape, LayerSpec, SHAPES

from . import (
    deepseek_v3_671b,
    gemma3_1b,
    gemma_7b,
    jamba_v01_52b,
    musicgen_medium,
    qwen15_4b,
    qwen2_moe_a27b,
    qwen2_vl_2b,
    smollm_360m,
    xlstm_125m,
)

_MODULES = {
    "deepseek-v3-671b": deepseek_v3_671b,
    "smollm-360m": smollm_360m,
    "jamba-v0.1-52b": jamba_v01_52b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "musicgen-medium": musicgen_medium,
    "gemma-7b": gemma_7b,
    "gemma3-1b": gemma3_1b,
    "xlstm-125m": xlstm_125m,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "qwen1.5-4b": qwen15_4b,
}

ARCHS: dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE_ARCHS: dict[str, ArchConfig] = {k: m.SMOKE for k, m in _MODULES.items()}


def get_config(arch: str, *, smoke: bool = False) -> ArchConfig:
    table = SMOKE_ARCHS if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(table)}")
    return table[arch]


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


__all__ = [
    "ARCHS",
    "ArchConfig",
    "InputShape",
    "LayerSpec",
    "SHAPES",
    "SMOKE_ARCHS",
    "get_config",
    "get_shape",
]
