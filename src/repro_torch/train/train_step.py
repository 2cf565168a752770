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
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update, sum_of_squares
from . import schedule as schedules

__all__ = ["TrainState", "make_train_step", "init_train_state", "global_sq_norm"]


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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of it); any other tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def global_sq_norm(grads: Dict[str, torch.Tensor], data_sharded, model_sharded,
                   data_group=None, model_group=None) -> torch.Tensor:
    """The squared norm of the whole gradient from this rank's blocks:
    each leaf's blocks summed over the axes that cut it (``data_sharded``
    names those cut over the data axes, ``model_sharded`` those cut over
    the model axis), and a leaf replicated over an axis counted once, not
    once a rank of it.  A collective over both groups."""
    import torch.distributed as dist

    def part(on_data: bool, on_model: bool) -> torch.Tensor:
        sel = {k: g for k, g in grads.items()
               if (k in data_sharded) == on_data and (k in model_sharded) == on_model}
        return (sum_of_squares(sel) if sel
                else torch.zeros((), device=next(iter(grads.values())).device))

    both, data_only, model_only, neither = (
        part(d, m) for d, m in ((True, True), (True, False), (False, True), (False, False)))
    if data_group is not None:
        a = torch.stack([both, data_only])
        dist.all_reduce(a, group=data_group)
        both, data_only = a[0], a[1]
    if model_group is not None:
        b = torch.stack([both, model_only])
        dist.all_reduce(b, group=model_group)
        both, model_only = b[0], b[1]
    return both + data_only + model_only + neither


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig = AdamWConfig(),
    schedule: Callable = schedules.warmup_cosine,
    grad_accum: int = 1,
    group=None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``grad_accum > 1`` splits the batch into microbatches along axis 0 and
    sums their fp32 grads (one microbatch's graph at a time), then divides
    by their count, as the reference's scan does.  ``metrics`` holds 0-d
    tensors ``loss``, ``grad_norm``, ``lr_scale``, ``ce``, ``aux`` and
    ``tokens``; with microbatches ``loss``, ``ce`` and ``aux`` are their
    means and ``tokens`` their sum.

    ``group``: the process group over which ``model`` is data-parallel
    (FSDP2, as ``launch.train.make_sharded_train_step`` shards it).  The
    step then takes the GLOBAL batch, the same on every rank, and runs its
    rank's rows of each microbatch (all of them where the ranks do not
    divide it, as the reference's ``batch_sharding`` replicates it).  Each
    rank's cross-entropy is weighted by its share of the tokens and the
    MoE layers average their routing density over ``group``
    (``Model.data_group``), so that FSDP2's mean of the ranks' gradients
    is the gradient of the whole batch's loss; a parameter FSDP2 does not
    hold (one the rules replicate over the data axes) has its gradient
    averaged over ``group`` here.  The clip uses the norm over every
    shard, each counted once (``global_sq_norm``), and the metrics are the
    whole batch's.  A model cut over a model axis
    (``Model.model_axis``) runs its step on its blocks alike."""
    if group is None:
        n, rank = 1, 0
    else:
        import torch.distributed as dist

        n, rank = dist.get_world_size(group), dist.get_rank(group)
    model.data_group = group
    axis = model.model_axis

    def all_sum(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def own_rows(batch: Dict) -> Dict:
        b = len(batch["tokens"])
        if n == 1 or b % n:
            return batch
        return {k: v[rank * b // n:(rank + 1) * b // n] for k, v in batch.items()}

    def backward(batch: Dict) -> Dict[str, torch.Tensor]:
        """Adds this rank's part of the gradient of ``batch``'s loss into
        each parameter's ``.grad``; returns the batch's loss metrics."""
        _, met = model.loss(own_rows(batch))
        tokens = all_sum(met["tokens"])
        share = met["tokens"].float() / tokens.float()
        aux = torch.as_tensor(met["aux"], dtype=torch.float32, device=tokens.device)
        (met["ce"] * (n * share) + 0.01 * aux).backward()
        ce, aux = all_sum(met["ce"] * share), all_sum(aux) / n
        return {"loss": ce + 0.01 * aux, "ce": ce, "aux": aux, "tokens": tokens}

    def replicated_grads_mean(params) -> None:
        """The data-axes mean of the grads of the parameters FSDP2 does
        not hold (it averages the others in its reduce-scatter)."""
        if n == 1:
            return
        for p in params.values():
            if p.grad is not None and not hasattr(p.grad, "to_local"):
                dist.all_reduce(p.grad, group=group)
                p.grad.div_(n)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        for p in state.params.values():
            p.grad = None
        if grad_accum == 1:
            metrics = backward(batch)
        else:
            metrics = backward(_micro(batch, 0, grad_accum))
            for i in range(1, grad_accum):
                m_i = backward(_micro(batch, i, grad_accum))
                metrics = {k: metrics[k] + m_i[k] for k in metrics}
            metrics = {k: v if k == "tokens" else v / grad_accum for k, v in metrics.items()}
        with torch.no_grad():
            replicated_grads_mean(state.params)
            params = {k: _local(p) for k, p in state.params.items()}
            grads = {k: torch.zeros_like(params[k]) if p.grad is None else _local(p.grad).float()
                     for k, p in state.params.items()}
            if grad_accum > 1:
                for g in grads.values():
                    g.div_(grad_accum)
            opt = AdamWState(step=state.opt.step,
                             m={k: _local(t) for k, t in state.opt.m.items()},
                             v={k: _local(t) for k, t in state.opt.v.items()})
            sq_norm = None if group is None and axis is None else global_sq_norm(
                grads, {k for k, p in state.params.items() if hasattr(p, "to_local")},
                set() if axis is None else set(axis.dims), group,
                None if axis is None else axis.group)
            lr_scale = schedule(state.opt.step)
            _, opt, gnorm = adamw_update(params, grads, opt, opt_cfg, lr_scale, sq_norm=sq_norm)
        for p in state.params.values():
            p.grad = None
        out = {"loss": metrics.pop("loss"), "grad_norm": gnorm, "lr_scale": lr_scale, **metrics}
        return TrainState(params=state.params,
                          opt=AdamWState(step=opt.step, m=state.opt.m, v=state.opt.v)), out

    return train_step
