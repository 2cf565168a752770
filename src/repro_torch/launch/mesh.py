"""Device meshes for the launch entry points.

Port of ``repro/launch/mesh.py`` over ``torch.distributed.device_mesh``.
Functions, never module-level state: importing this module creates no
process group, as importing the reference's touches no device.

A mesh needs a default process group of the mesh's size.  Under
``torchrun`` (or any caller that initialised one) the existing group is
used; a one-process caller without one gets a 1-rank group over a
``HashStore`` (:func:`ensure_process_group`), so no ``MASTER_ADDR`` is
needed.  Meshes are on the card (``device_type="cuda"``) unless the caller
passes ``"cpu"`` (gloo).
"""
from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_custom_mesh", "make_local_mesh", "partition_params",
           "ensure_process_group"]

PRODUCTION_SHAPE = (16, 16)


def ensure_process_group(device_type: str = "cuda") -> bool:
    """Make a 1-rank default group when none exists (NCCL on the card,
    gloo on the CPU; a ``torchrun`` environment's own otherwise).  Returns
    whether this call made it, so that its caller can destroy it."""
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda" and "LOCAL_RANK" in os.environ:
        import torch

        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def _mesh(shape, names, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    ensure_process_group(device_type)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 devices per pod; 2 pods = 512 devices when multi_pod."""
    shape = (2,) + PRODUCTION_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_custom_mesh(data: int, model: int, device_type: str = "cuda"):
    """Single-pod mesh with a custom (data, model) factorisation."""
    return _mesh((data, model), ("data", "model"), device_type)


def make_local_mesh(device_type: str = "cuda"):
    """(world size, 1) over the process group's ranks, made 1-rank when no
    group exists (tests, examples, one card)."""
    import torch.distributed as dist

    ensure_process_group(device_type)
    return _mesh((dist.get_world_size(), 1), ("data", "model"), device_type)


def partition_params(mesh, params):
    """DTensor placements for a dict of parameters on ``mesh`` (the
    ``dist.sharding.param_sharding`` rules)."""
    from ..dist.sharding import param_sharding

    return param_sharding(mesh, params)
