"""Training step: loss -> grads -> AdamW, with microbatch accumulation.

Port of ``repro/train/train_step.py``.  Remat is inside ``Model.loss``
(each layer, group and cross-entropy chunk under ``torch.utils.checkpoint``)
and mixed precision inside the model (fp32 masters from
``Model.trainable()``, cast to ``cfg.dtype`` at each use).

A ``TrainState``'s ``params`` are the model's own parameters, by name, and
a step updates them and the optimizer's moments in place (the reference
returns new arrays); it returns the state with the new ``opt``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ..models.model import Model
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update
from . import schedule as schedules

__all__ = ["TrainState", "make_train_step", "init_train_state"]


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt: AdamWState


def init_train_state(model: Model, generator: torch.Generator) -> TrainState:
    """Make ``model`` trainable (fp32 masters that take gradients), draw its
    weights from ``generator`` and give it zero moments."""
    model.trainable().init(generator)
    params = dict(model.named_parameters())
    return TrainState(params=params, opt=adamw_init(params))


def _micro(batch: Dict, i: int, n: int) -> Dict:
    """Microbatch ``i`` of ``n`` along axis 0 of every entry."""
    b = len(batch["tokens"]) // n
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig = AdamWConfig(),
    schedule: Callable = schedules.warmup_cosine,
    grad_accum: int = 1,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``grad_accum > 1`` splits the batch into microbatches along axis 0 and
    sums their fp32 grads (one microbatch's graph at a time), then divides
    by their count, as the reference's scan does.  ``metrics`` holds 0-d
    tensors ``loss``, ``grad_norm``, ``lr_scale``, ``ce``, ``aux`` and
    ``tokens``; with microbatches ``loss``, ``ce`` and ``aux`` are their
    means and ``tokens`` their sum."""

    def grads_of(params: Dict[str, torch.Tensor], batch: Dict):
        loss, metrics = model.loss(batch)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g.float()
                 for k, g in zip(names, grads)}
        return loss.detach(), {k: torch.as_tensor(v, device=loss.device).detach()
                               for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if grad_accum == 1:
            loss, metrics, grads = grads_of(state.params, batch)
        else:
            loss, metrics, grads = grads_of(state.params, _micro(batch, 0, grad_accum))
            for i in range(1, grad_accum):
                l_i, m_i, g_i = grads_of(state.params, _micro(batch, i, grad_accum))
                for k, g in g_i.items():
                    grads[k].add_(g)
                loss = loss + l_i
                metrics = {k: metrics[k] + m_i[k] for k in metrics}
                del g_i
            for g in grads.values():
                g.div_(grad_accum)
            loss = loss / grad_accum
            metrics = {k: v if k == "tokens" else v / grad_accum for k, v in metrics.items()}
        lr_scale = schedule(state.opt.step)
        params, opt, gnorm = adamw_update(state.params, grads, state.opt, opt_cfg, lr_scale)
        out = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale, **metrics}
        return TrainState(params=params, opt=opt), out

    return train_step
