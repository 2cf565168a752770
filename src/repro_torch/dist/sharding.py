"""Sharding rules: parameter name -> spec -> DTensor placements.

Port of ``repro/dist/sharding.py``.  One rule table drives every layer
family (the reference's, unchanged):

* **column-parallel** (``wq``/``wk``/``wv``/``wi``/``w_gate``/``w_up``/
  ``w_in``/``lm_head``): the *output* feature dim is sharded on the model
  axis, the *input* dim carries the FSDP (data-axes) shard;
* **row-parallel** (``wo``/``w_down``/``w_out``): the *input* dim on the
  model axis, the output dim carries the FSDP shard;
* **expert-parallel MoE** (same names, one extra leading expert dim): the
  expert dim takes the model axis, the within-expert input dim (column) or
  output dim (row) the data axes;
* **vocab-sharded embedding** (``embed``: ``(V, d)`` vocab on model);
* **everything else** (norm scales, conv kernels, SSM state projections)
  is replicated.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name, or
a tuple of axis names (the data axes, ``("pod", "data")`` on a multi-pod
mesh, shard one dim jointly, pod major).  :func:`param_spec` is the pure
rule with the reference's signature, over the reference's paths
(``layers/attn/wq``) and stacked shapes (leading layer dims, never
sharded).  The port keeps one tensor a layer (``layers.3.attn.wq``,
``blocks.1.mlstm.2.wq``): :func:`named_param_spec` maps such a name to the
reference's path, applies the rule to the shape with the stacked dims
restored, and drops their entries again.

:func:`param_sharding`, :func:`batch_sharding` and :func:`cache_sharding`
turn specs into DTensor placements on a ``DeviceMesh`` (one placement a
mesh dim: ``Shard(d)`` where the spec names that mesh axis on tensor dim
d, else ``Replicate()``), with the reference's divisibility guard: a dim
the mesh cannot split evenly is replicated (DTensor would allow uneven
shards; the reference does not).  :func:`shard` distributes tensors by
such placements (under ``FakeTensorMode`` it allocates nothing).

:func:`model_dim` and :func:`local_shard` say what one rank holds without
a ``DeviceMesh``: the dim the model axis cuts under the guard, and the
block of a whole tensor at given mesh coordinates under given placements
(``Shard(d)`` cuts dim d into equal chunks, mesh dims in order).  The
tensor-parallel step (``dist.tensor_parallel``) cuts the weights on the
model axis with them, and the tests check each rank's shards by them.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

__all__ = [
    "param_spec",
    "named_param_spec",
    "reference_path",
    "param_sharding",
    "batch_sharding",
    "cache_sharding",
    "data_axes",
    "placements",
    "shard",
    "model_dim",
    "local_shard",
]

Spec = Tuple  # one entry a tensor dim: None, an axis name, or a tuple of names

# matmul weights by the convention above; anything else replicates
_COLUMN_PARALLEL = {"wq", "wk", "wv", "wi", "w_gate", "w_up", "w_in", "lm_head"}
_ROW_PARALLEL = {"wo", "w_down", "w_out"}
# subtrees whose leaves carry a leading stacked-layer dim in the reference
_STACKED_ROOTS = {"layers", "blocks", "enc_layers"}


def data_axes(mesh) -> Tuple[str, ...]:
    """All mesh axes that are not the tensor-parallel axis ("model"): they
    jointly act as the FSDP/data-parallel dimension."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def param_spec(path: str, shape: Sequence[int], data_axes: Tuple[str, ...], model_axis: str,
               layer_axis: int) -> Spec:
    """Spec for one parameter of the reference's layout: ``path`` is the
    "/"-joined tree path (only its last name is matched), ``layer_axis``
    the number of leading stacked-layer dims, left unsharded."""
    name = path.split("/")[-1]
    lead = (None,) * layer_axis
    rest = len(shape) - layer_axis

    if name == "embed" and layer_axis == 0 and rest == 2:
        return (model_axis, None)                        # vocab-sharded
    if name in _COLUMN_PARALLEL:
        if rest == 2:
            return (*lead, data_axes, model_axis)
        if rest == 3:                                    # MoE (E, in, out)
            return (*lead, model_axis, data_axes, None)
    if name in _ROW_PARALLEL:
        if rest == 2:
            return (*lead, model_axis, data_axes)
        if rest == 3:                                    # MoE (E, in, out)
            return (*lead, model_axis, None, data_axes)
    return (None,) * len(shape)                          # replicated


def _layer_axis_for(path: str) -> int:
    """The reference's count of leading stacked dims of a tree path."""
    parts = path.split("/")
    if not parts or parts[0] not in _STACKED_ROOTS:
        return 0
    # xLSTM interleave: blocks/mlstm/* is stacked (groups, every-1, ...)
    if parts[0] == "blocks" and "mlstm" in parts[1:-1]:
        return 2
    return 1


def reference_path(name: str) -> Tuple[str, int]:
    """A port parameter name -> (the reference's tree path, its stacked
    dims): ``layers.3.attn.wq`` -> (``layers/attn/wq``, 1),
    ``blocks.1.mlstm.2.wq`` -> (``blocks/mlstm/wq``, 2).  The layer (and
    group, block) indices of the name are the stacked dims the reference's
    leaf has and the port's tensor does not."""
    parts = name.split(".")
    path = "/".join(p for p in parts if not p.isdigit())
    n_idx = sum(p.isdigit() for p in parts)
    if _layer_axis_for(path) != n_idx:
        raise ValueError(f"{name}: {n_idx} layer indices, but the reference stacks "
                         f"{_layer_axis_for(path)} dims at {path}")
    return path, n_idx


def named_param_spec(name: str, shape: Sequence[int], data_axes: Tuple[str, ...],
                     model_axis: str = "model") -> Spec:
    """Spec of the port's parameter ``name`` (unstacked ``shape``): the
    reference's rule on its path and stacked shape, the stacked entries
    dropped (the reference never shards them)."""
    path, lead = reference_path(name)
    return param_spec(path, (1,) * lead + tuple(shape), data_axes, model_axis, lead)[lead:]


def _sizes(mesh) -> Dict[str, int]:
    """Axis name -> its size on ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: Mapping[str, int], entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(sizes[a] for a in entry)
    return sizes[entry]


def _guard_divisible(sizes: Mapping[str, int], spec: Spec, shape: Sequence[int]) -> Spec:
    """Replace any spec entry whose mesh extent doesn't divide the dim."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(entry if dim % _axis_size(sizes, entry) == 0 else None
                 for dim, entry in zip(shape, spec))


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d's entry names it, else
    ``Replicate()``.  Two mesh dims on one tensor dim (``("pod", "data")``)
    shard it in mesh order, pod major, as a joint JAX axis does."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if axis is not None:
                where[axis] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in mesh.mesh_dim_names)


def param_sharding(mesh, named: Mapping[str, torch.Tensor]) -> Dict[str, tuple]:
    """Placements for each parameter (or optimizer moment) by the port's
    name, on ``mesh``."""
    d_axes = data_axes(mesh)
    sizes = _sizes(mesh)
    return {name: placements(mesh, _guard_divisible(
                sizes, named_param_spec(name, t.shape, d_axes), t.shape))
            for name, t in named.items()}


def _leading_batch_spec(mesh, t: torch.Tensor, global_batch: int, max_axis: int):
    d_axes = data_axes(mesh)
    n_data = math.prod(_sizes(mesh)[a] for a in d_axes)
    if global_batch >= n_data and global_batch % n_data == 0:
        for ax in range(min(max_axis, t.dim())):
            if t.shape[ax] == global_batch:
                spec = [None] * t.dim()
                spec[ax] = d_axes
                return tuple(spec)
    return (None,) * t.dim()


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def batch_sharding(mesh, batch, global_batch: int):
    """Placements sharding each entry's leading batch dim over the data
    axes when they divide it (a tree of the batch's shape)."""
    return _map(batch, lambda t: placements(mesh, _leading_batch_spec(mesh, t, global_batch, 1)))


def cache_sharding(mesh, cache, global_batch: int):
    """Decode-cache placements: the batch dim, the first of the leading
    three dims equal to ``global_batch`` (K/V are (L, B, ...); xLSTM mLSTM
    states (G, every-1, B, ...)), on the data axes; the rest replicated."""
    return _map(cache, lambda t: placements(mesh, _leading_batch_spec(mesh, t, global_batch, 3)))


def shard(mesh, tensors, placement_tree):
    """``distribute_tensor`` of each tensor by its placements (trees of the
    same shape).  Under ``FakeTensorMode`` nothing is allocated."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tensors, Mapping):
        return {k: shard(mesh, v, placement_tree[k]) for k, v in tensors.items()}
    return distribute_tensor(tensors, mesh, list(placement_tree))


def model_dim(name: str, shape: Sequence[int], n_model: int) -> Optional[int]:
    """The dim of the port's parameter ``name`` (whole ``shape``) that a
    model axis of ``n_model`` shards, under the reference's divisibility
    guard; None where the weight stays replicated on it."""
    spec = _guard_divisible({"model": n_model}, named_param_spec(name, shape, ()), shape)
    dims = [d for d, entry in enumerate(spec) if entry == "model"]
    return dims[0] if dims and n_model > 1 else None


def local_shard(t: torch.Tensor, placement: Sequence, sizes: Sequence[int],
                coords: Sequence[int]) -> torch.Tensor:
    """The block of the whole tensor ``t`` that the rank at mesh
    ``coords`` holds under ``placement`` (one entry a mesh dim, as
    :func:`param_sharding` gives them) on a mesh of ``sizes``: each
    ``Shard(d)`` cuts dim d into equal chunks, in mesh-dim order (two mesh
    dims on one tensor dim cut it major first, as DTensor does).  A view."""
    from torch.distributed.tensor import Shard

    for p, n, c in zip(placement, sizes, coords):
        if isinstance(p, Shard):
            size = t.shape[p.dim] // n
            t = t.narrow(p.dim, c * size, size)
    return t
