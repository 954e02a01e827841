"""Config registry: ``get_config(arch_id)`` for every assigned arch (the
port's copy of ``repro.configs``)."""
from __future__ import annotations

import importlib

from .base import ArchConfig, ShapeCell, SHAPES

_REGISTRY = {
    "mamba2-2.7b": "mamba2_2p7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "paligemma-3b": "paligemma_3b",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama3-8b": "llama3_8b",
    "qwen3-0.6b": "qwen3_0p6b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "stablelm-3b": "stablelm_3b",
    "vit-base": "vit_base",
}

ASSIGNED_ARCHS = [k for k in _REGISTRY if k != "vit-base"]


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    mod = importlib.import_module(f".{_REGISTRY[name]}", __package__)
    return mod.CONFIG


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape-cell) pair of the assigned grid, skips excluded."""
    out = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for cell in cfg.cells():
            out.append((arch, cell))
    return out


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "get_config",
           "ASSIGNED_ARCHS", "all_cells"]
