"""Config registry: ``get_config("<arch-id>")``.

Holds the configurations the port can serve: the dense family without
attention softcap or sliding windows (``models.model.Model`` refuses the
rest).  Other architectures join with their families (ROADMAP Queue 1).
"""
from .base import ModelConfig, SHAPES, ShapeSpec

from .qwen3_14b import CONFIG as _qwen3_14b

REGISTRY = {c.name: c for c in [_qwen3_14b]}

ARCH_IDS = sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "SHAPES", "ShapeSpec", "REGISTRY", "ARCH_IDS", "get_config"]
