"""AdamW on dicts of tensors, the reference's arithmetic.

Port of ``repro/train/optimizer.py``.  States mirror the parameters (a dict
of fp32 tensors by parameter name); parameters are fp32 masters.  One step
clips by the global norm (returned from before clipping), then applies
Adam's bias-corrected moments and decoupled weight decay, in place, one
parameter at a time so that no temporary is larger than one parameter.
``torch.optim``'s fused AdamW is other arithmetic and is not used.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "sum_of_squares"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the parameters' device
    m: Tensors
    v: Tensors


def adamw_init(params: Tensors) -> AdamWState:
    zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros,
                      v={k: z.clone() for k, z in zeros.items()})


def sum_of_squares(grads: Tensors) -> torch.Tensor:
    """The squared global norm of ``grads``, a 0-d fp32 tensor."""
    return torch.stack([torch.sum(g.float() * g.float()) for g in grads.values()]).sum()


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: AdamWState, cfg: AdamWConfig,
                 lr_scale, sq_norm=None) -> Tuple[Tensors, AdamWState, torch.Tensor]:
    """One AdamW step.  Returns (params, new_state, grad_norm): ``params``
    and the state's ``m``/``v`` are the given tensors, updated in place;
    ``grads`` are left as they were.  ``sq_norm``, the squared norm of the
    whole gradient, replaces that of ``grads`` where they are one shard of
    it (a data-parallel step clips by the global norm)."""
    if sq_norm is None:
        sq_norm = sum_of_squares(grads)
    gnorm = torch.sqrt(sq_norm + 1e-16)
    scale = torch.clamp_max(cfg.clip_norm / gnorm, 1.0) if cfg.clip_norm > 0 else 1.0
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=gnorm.device)
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state.m[k], state.v[k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p
        p.sub_(lr * upd)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
