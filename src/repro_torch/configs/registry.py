"""Architecture registry: ``--arch <id>`` resolution for launchers/tests."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                      applicable)

_MODULES = {
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3p8b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3p5_moe_42b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).SMOKE


def get_shape(shape_id: str) -> ShapeConfig:
    return SHAPES[shape_id]


def all_cells():
    """All 40 (arch x shape) assignment cells with runnability."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s, shape in SHAPES.items():
            ok, why = applicable(cfg, shape)
            out.append((a, s, ok, why))
    return out
