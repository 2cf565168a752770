"""Tensor parallelism over a mesh's ``model`` axis, with all-reduce only.

The reference gets its model axis from GSPMD: ``launch/train.py`` jits
the step with ``in_shardings`` from ``dist/sharding.py``'s rules and XLA
partitions the computation.  The port stores each weight exactly where
those rules put it (:func:`repro_torch.dist.sharding.model_dim`: the
model axis cuts one dim of a column- or row-parallel weight, the expert
dim of an MoE weight and the vocab of ``embed``, under the reference's
divisibility guard) and splits the compute as Megatron's tensor
parallelism without sequence parallelism does:

* a unit whose cut falls on whole units of its computation runs split:
  attention when the model axis divides the KV heads (a rank holds whole
  KV groups with all their query heads), an MLP when it divides ``d_ff``,
  the experts when it divides their count, the vocab (embedding lookup,
  head and cross-entropy) when it divides the vocab.  Its input enters
  through :func:`copy_to_model` and its output leaves through
  :func:`reduce_from_model`;
* every other weight the rules cut (the recurrences' projections, an
  attention whose cut falls inside a KV group) is made whole before use
  by :func:`gather_model`, and its unit runs replicated;
* the residual stream between units is replicated over the model axis.

Serving (``Model.prefill``, ``Model.decode_step``, ``ServeEngine``) runs
on the same cut: the KV cache stays whole on every rank, replicated over
the model axis as the reference's ``cache_sharding`` places it.  Where
attention runs split, each rank computes the K/V of its own KV groups,
:func:`gather_model` makes them whole (K and V stacked: one all-reduce of
the zero-padded blocks), every rank writes every head, so the cache stays
a true replica, and the decode kernel reads the rank's heads
``ModelAxis.kv_heads`` of it in place.

Each of the operations sends one ``all_reduce`` (a sum) over the
model group and nothing else, so the same code runs over NCCL across
cards and over gloo, which carries only ``all_reduce`` and ``broadcast``
for CUDA tensors: several CPU processes, or several processes sharing one
card.

:func:`split_units` says which units split for a config and a model-axis
size, :class:`ModelAxis` how each weight is used, and :func:`shard_model`
cuts a whole model's weights to one rank's blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .sharding import local_shard, model_dim

__all__ = ["copy_to_model", "reduce_from_model", "gather_model", "split_units", "ModelAxis",
           "shard_model"]

_MLP = ("w_gate", "w_up", "w_down")
_QK_NORMS = ("q_norm", "k_norm")


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, rank, n):
        import torch.distributed as dist

        ctx.dim, ctx.rank, ctx.size = dim, rank, t.shape[dim]
        shape = list(t.shape)
        shape[dim] *= n
        whole = t.new_zeros(shape)
        whole.narrow(dim, rank * t.shape[dim], t.shape[dim]).copy_(t)
        dist.all_reduce(whole, group=group)
        return whole

    @staticmethod
    def backward(ctx, g):
        block = g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous()
        return block, None, None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a split unit: ``x`` itself; its gradient is summed
    over the model group (each rank's holds its own block's part)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a split unit: the sum of the ranks' partial outputs
    over the model group; its gradient passes through."""
    return _ReduceFromModel.apply(x, group)


def gather_model(t: torch.Tensor, group, dim: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s block ``t`` of a tensor cut into ``n`` equal chunks
    on ``dim``, made whole on every rank: an all-reduce of a zero buffer
    holding the block in its place, exact in any type.  The gradient of
    the whole tensor, which every rank computes alike, gives back the
    rank's block of it."""
    return _GatherModel.apply(t, group, dim, rank, n)


def split_units(cfg: ModelConfig, n: int) -> Dict[str, bool]:
    """Which units of ``cfg`` run split over a model axis of ``n``: each
    where the axis cuts on whole units of its computation (KV groups of
    heads, MLP columns, experts, vocab rows); the others' weights are
    gathered before use."""
    return {"attn": cfg.n_kv_heads % n == 0,
            "mlp": cfg.d_ff > 0 and cfg.d_ff % n == 0,
            "experts": cfg.n_experts > 0 and cfg.n_experts % n == 0,
            "vocab": cfg.vocab_size % n == 0}


def _unit_of(name: str, ndim: int) -> Optional[str]:
    """The split unit a parameter belongs to, by its port name."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if name in ("embed", "lm_head"):
        return "vocab"
    if parent in ("attn", "xattn"):
        return "attn"
    if parent == "ffn" and leaf in _MLP and ndim == 3:
        return "experts"
    if parent in ("ffn", "shared") and leaf in _MLP:
        return "mlp"
    return None


class _Weights:
    """A ``Params`` module's weights as one rank's compute reads them:
    gathered whole, passed through :func:`copy_to_model` (a replicated
    weight used inside a split unit: its gradient is partial on each
    rank) or as stored."""

    def __init__(self, pd: nn.Module, axis: "ModelAxis"):
        self.pd, self.axis = pd, axis

    def __getitem__(self, name: str):
        v = self.pd[name]
        if isinstance(v, nn.Module):
            return self.axis.weights(v)
        how, dim = getattr(self.pd, "model_axis_use", {}).get(name, ("whole", None))
        if how == "copy":
            return self.axis.enter(v)
        return self.axis.gather(v, dim) if how == "gather" else v


class ModelAxis:
    """One rank's view of a model axis of ``n`` ranks (``group``, this
    process at ``rank`` in it) for ``cfg``: which units split
    (``split``), the attention's config over this rank's heads
    (``attn_cfg``) and the cache heads they are (``kv_heads``), the vocab
    rows it holds (``vocab0``, ``vocab_rows``), and for each weight the dim
    the axis cuts (``dims``; absent where it is replicated)."""

    def __init__(self, cfg: ModelConfig, group, n: int, rank: int):
        self.cfg, self.group, self.n, self.rank = cfg, group, n, rank
        self.split = split_units(cfg, n)
        self.attn_cfg = (dataclasses.replace(cfg, n_heads=cfg.n_heads // n,
                                             n_kv_heads=cfg.n_kv_heads // n)
                         if self.split["attn"] else cfg)
        self.vocab_rows = cfg.vocab_size // n
        self.vocab0 = rank * self.vocab_rows
        self.dims: Dict[str, int] = {}

    @property
    def kv_heads(self) -> Tuple[int, int]:
        """(kv0, KV_local): the KV heads of the whole cache this rank's
        attention reads: its own KV groups where attention runs split, else
        every head."""
        kvl = self.attn_cfg.n_kv_heads
        return (self.rank * kvl if self.split["attn"] else 0), kvl

    def use(self, name: str, shape) -> Tuple[str, Optional[int]]:
        """How this rank's compute uses the weight ``name`` of whole
        ``shape``: ("split", dim) a block of a split unit, read as stored;
        ("gather", dim) a block made whole before use; ("copy", None) a
        replicated weight inside a split unit (q/k norms); ("whole", None)
        a replicated weight of replicated compute."""
        dim = model_dim(name, shape, self.n)
        unit = _unit_of(name, len(shape))
        if unit is not None and self.split[unit]:
            if dim is not None:
                return "split", dim
            return ("copy" if name.split(".")[-1] in _QK_NORMS else "whole"), None
        return ("gather", dim) if dim is not None else ("whole", None)

    # -- the three operations over this axis's group ------------------
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(x, self.group)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return gather_model(t, self.group, dim, self.rank, self.n)

    # -- weights -----------------------------------------------------
    def weights(self, pd: nn.Module) -> _Weights:
        """``pd``'s weights as this rank's compute reads them."""
        return _Weights(pd, self)

    def block(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` of weight ``name``
        (``t`` itself where the axis does not cut it); a view."""
        from torch.distributed.tensor import Shard

        dim = self.dims.get(name)
        return t if dim is None else local_shard(t, (Shard(dim),), (self.n,), (self.rank,))

    @torch.no_grad()
    def whole(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The whole tensor of weight ``name`` from this rank's block
        ``t`` (a collective: every rank of the group calls it)."""
        dim = self.dims.get(name)
        return t if dim is None else self.gather(t, dim)

    # -- the vocab ----------------------------------------------------
    def vocab_mask(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids made local to this rank's rows and clamped into them,
        whether each id is one of its rows)."""
        local = ids - self.vocab0
        inside = (local >= 0) & (local < self.vocab_rows)
        return torch.clamp(local, 0, self.vocab_rows - 1), inside

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks (no gradient), by a
        sum: each rank's values in its own row of a zero buffer."""
        rows = t.new_zeros((self.n,) + tuple(t.shape))
        rows[self.rank] = t.detach()
        return _all_reduce(rows, self.group).amax(0)


@torch.no_grad()
def shard_model(model, group) -> ModelAxis:
    """Cut ``model``'s whole weights to this rank's blocks of a model axis
    (``group``): each weight the rules cut is re-registered as a new
    parameter holding its block, and each ``Params`` module records how
    its weights are read (``model_axis_use``).  Sets and returns
    ``model.model_axis``."""
    import torch.distributed as dist

    axis = ModelAxis(model.cfg, group, dist.get_world_size(group), dist.get_rank(group))
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            how, dim = axis.use(name, p.shape)
            if dim is not None:
                axis.dims[name] = dim
                mod.register_parameter(pname, nn.Parameter(
                    axis.block(p.detach(), name).clone(), requires_grad=p.requires_grad))
            if how in ("gather", "copy"):
                if not hasattr(mod, "model_axis_use"):
                    mod.model_axis_use = {}
                mod.model_axis_use[pname] = (how, dim)
    model.model_axis = axis
    return axis
