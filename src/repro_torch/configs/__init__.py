"""Config registry: ``get_config("<arch-id>")``.

Holds the configurations the port can serve: the dense family (qwen3-14b,
qwen3-32b, gemma2-2b with its sliding windows and softcaps; deepseek-67b,
whose 134.8 GB of bf16 weights do not fit one card, is for the dry-run and
reduced runs), the MoE family
(olmoe-1b-7b; llama4-scout, whose ~109B parameters do not fit one card,
served reduced), the hybrid family (hymba-1.5b: attention beside a Mamba
head, sliding windows but for three global layers) and the ssm family
(xlstm-1.3b: sLSTM and mLSTM blocks), the encdec family
(seamless-m4t-large-v2: a bidirectional encoder over stub speech frames,
and a decoder that cross-attends to it) and the vlm family (internvl2-76b:
stub image patches prepended to the prompt of a dense backbone, whose
141 GB of bf16 weights do not fit one card: served at 8 of its 80 layers).
``paper_ann`` holds the paper's filtered-ANN dataset configurations
(``ANN_CONFIGS``), as the reference's does; it is not in the registry.
"""
from .base import ModelConfig, SHAPES, ShapeSpec

from .gemma2_2b import CONFIG as _gemma2_2b
from .qwen3_14b import CONFIG as _qwen3_14b
from .qwen3_32b import CONFIG as _qwen3_32b
from .deepseek_67b import CONFIG as _deepseek_67b
from .olmoe_1b_7b import CONFIG as _olmoe
from .llama4_scout_17b_a16e import CONFIG as _llama4
from .hymba_1_5b import CONFIG as _hymba
from .xlstm_1_3b import CONFIG as _xlstm
from .seamless_m4t_large_v2 import CONFIG as _seamless
from .internvl2_76b import CONFIG as _internvl2_76b

REGISTRY = {c.name: c for c in [_gemma2_2b, _qwen3_14b, _qwen3_32b, _deepseek_67b, _olmoe,
                                 _llama4, _hymba, _xlstm, _seamless, _internvl2_76b]}

ARCH_IDS = sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "SHAPES", "ShapeSpec", "REGISTRY", "ARCH_IDS", "get_config"]
