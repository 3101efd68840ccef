"""Config registry: ``get_config("minitron-8b")``, ``get_shape("train_4k")``."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (
    ALL_SHAPES,
    ArchConfig,
    SHAPES,
    ShapeSpec,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
)
from repro_torch.configs import archs as _archs

_REGISTRY: Dict[str, ArchConfig] = {
    c.arch_id: c for c in (*_archs.ASSIGNED, *_archs.PAPER)
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def list_archs(assigned_only: bool = False) -> List[str]:
    src = _archs.ASSIGNED if assigned_only else _REGISTRY.values()
    return [c.arch_id for c in src]


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


__all__ = [
    "ArchConfig", "ShapeSpec", "get_config", "get_shape", "list_archs",
    "register", "ALL_SHAPES", "SHAPES",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
