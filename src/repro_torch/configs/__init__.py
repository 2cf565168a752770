"""Config registry: ``get_config("<arch-id>")``.

Holds the configurations the port can serve: the dense family (qwen3-14b,
gemma2-2b with its sliding windows and softcaps), the MoE family
(olmoe-1b-7b; llama4-scout, whose ~109B parameters do not fit one card,
served reduced), the hybrid family (hymba-1.5b: attention beside a Mamba
head, sliding windows but for three global layers) and the ssm family
(xlstm-1.3b: sLSTM and mLSTM blocks).  The encdec and vlm architectures
join with their families (ROADMAP Queue 1); ``models.model.Model`` refuses
them.
"""
from .base import ModelConfig, SHAPES, ShapeSpec

from .gemma2_2b import CONFIG as _gemma2_2b
from .qwen3_14b import CONFIG as _qwen3_14b
from .olmoe_1b_7b import CONFIG as _olmoe
from .llama4_scout_17b_a16e import CONFIG as _llama4
from .hymba_1_5b import CONFIG as _hymba
from .xlstm_1_3b import CONFIG as _xlstm

REGISTRY = {c.name: c for c in [_gemma2_2b, _qwen3_14b, _olmoe, _llama4, _hymba, _xlstm]}

ARCH_IDS = sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "SHAPES", "ShapeSpec", "REGISTRY", "ARCH_IDS", "get_config"]
