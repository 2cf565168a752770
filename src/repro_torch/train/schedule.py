"""Learning-rate schedules (pure functions of the step).

Port of ``repro/train/schedule.py``: the step is an int or a 0-d tensor
(``AdamWState.step``), and the scale is a 0-d fp32 tensor on the step's
device, computed in fp32 as the reference's.
"""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, warmup: int = 200, total: int = 10_000, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor`` of peak; returns a scale
    in [0, 1] multiplying the optimizer's base lr."""
    step = _f32(step)
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step):
    return torch.ones_like(_f32(step))
