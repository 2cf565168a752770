"""End-to-end training from the command line, over a device mesh.

Port of ``repro/launch/train.py`` with the same flags and prints, plus
``--device`` (default ``cuda``; pass ``cpu`` to run without a card):

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 50 \\
        --reduced --ckpt-dir /tmp/ckpt
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch gemma2-2b

Wires together: config registry -> model (fp32 masters) -> the mesh's
sharded train step -> deterministic data pipeline -> checkpointing (async,
atomic, auto-resume) -> fault hooks (heartbeat + straggler monitors).  The
mesh is ``make_local_mesh()`` (world size x 1; one process without
``torchrun`` makes its own 1-rank group) or, with ``--production-mesh``,
``make_production_mesh()``, as in the reference.

:func:`make_sharded_train_step` is the data-parallel (FSDP) half of the
reference's ``jax.jit(step, in_shardings=...)``: FSDP2 shards the state
over the mesh's data axes, one unit a decoder layer (or xLSTM group) and
one at the root, each weight on the dim where ``dist.sharding`` puts the
data axes.  A mesh whose ``model`` axis is larger than 1 needs
tensor-parallel training, which is not ported: it raises
``NotImplementedError`` before anything is allocated, and so does the
production mesh (16 x 16, model axis 16).  Checkpoints hold full tensors
in the reference's layout (``carry.train_state_to_reference``), so either
package's CLI resumes the other's.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, Dict, Tuple

import torch

from ..carry import train_state_from_reference, train_state_to_reference
from ..ckpt.checkpoint import Checkpointer
from ..configs import get_config
from ..data.pipeline import TokenPipeline
from ..device import resolve_device
from ..dist.fault import HeartbeatMonitor, StragglerMitigator
from ..dist.sharding import data_axes, named_param_spec
from ..models.model import Model
from ..train import schedule as schedules
from ..train.optimizer import AdamWConfig, AdamWState
from ..train.train_step import TrainState, init_train_state, make_train_step
from .mesh import PRODUCTION_SHAPE, ensure_process_group, make_local_mesh, make_production_mesh

__all__ = ["make_sharded_train_step", "data_mesh", "full_state", "main"]

TENSOR_PARALLEL_ITEM = "ROADMAP Queue 1 item 13.5"


def _refuse(why: str):
    raise NotImplementedError(
        f"{why}: tensor-parallel training (a mesh whose model axis is larger than 1) is not "
        f"ported to repro_torch yet ({TENSOR_PARALLEL_ITEM}); item 13.2 ported the "
        "data-parallel mesh, make_local_mesh()")


def data_mesh(mesh):
    """The 1-D mesh over ``mesh``'s data axes (flattened when there are
    several), which FSDP2 shards over; raises ``NotImplementedError`` for
    a model axis larger than 1."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if sizes.get("model", 1) > 1:
        _refuse(f"a mesh with a model axis of {sizes['model']}")
    axes = data_axes(mesh)
    return mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()


def _placement_fn(model: Model, n_data: int, d_axes) -> Callable:
    """FSDP2's ``shard_placement_fn``: ``Shard(d)`` on the dim where
    ``dist.sharding`` puts the data axes (the input dim of a column-parallel
    weight, the output dim of a row-parallel one), when they divide it;
    None (FSDP2's default ``Shard(0)``) for the leaves the reference
    replicates."""
    from torch.distributed.tensor import Shard

    place = {}
    for name, p in model.named_parameters():
        spec = named_param_spec(name, p.shape, d_axes)
        dims = [d for d, e in enumerate(spec) if e == d_axes and p.shape[d] % n_data == 0]
        place[id(p)] = Shard(dims[0]) if dims else None
    return lambda p: place.get(id(p))


def make_sharded_train_step(model: Model, mesh, state: TrainState,
                            opt_cfg: AdamWConfig = AdamWConfig(),
                            schedule: Callable = schedules.warmup_cosine,
                            grad_accum: int = 1) -> Tuple[Callable, TrainState]:
    """Shard ``model`` and ``state`` (full tensors: ``init_train_state``'s,
    or a restored checkpoint's) over ``mesh``'s data axes with FSDP2.
    Returns ``(train_step, sharded_state)``: ``train_step`` is
    ``make_train_step``'s over the data axes' process group, which takes
    the GLOBAL batch, every rank the same, and gives the one-process step's
    update of the whole batch."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import distribute_tensor

    dmesh = data_mesh(mesh)
    place = _placement_fn(model, dmesh.size(), data_axes(mesh))
    units = list(model.blocks if model.cfg.family == "ssm" else model.layers)
    if model.cfg.is_encdec:
        units += list(model.enc_layers)
    for unit in units:
        fully_shard(unit, mesh=dmesh, shard_placement_fn=place)
    fully_shard(model, mesh=dmesh, shard_placement_fn=place)
    register_fsdp_forward_method(model, "loss")
    params = dict(model.named_parameters())

    def moments(full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: distribute_tensor(full[k].detach().to(p.device, torch.float32), dmesh,
                                     p.placements, src_data_rank=None)
                for k, p in params.items()}

    sharded = TrainState(params=params, opt=AdamWState(
        step=state.opt.step, m=moments(state.opt.m), v=moments(state.opt.v)))
    return make_train_step(model, opt_cfg, schedule, grad_accum, group=dmesh.get_group()), sharded


def full_state(state: TrainState) -> TrainState:
    """A sharded ``TrainState`` with every tensor gathered whole (a
    collective: every rank calls it)."""
    def full(tree):
        return {k: t.full_tensor() if hasattr(t, "full_tensor") else t for k, t in tree.items()}

    return TrainState(params=full(state.params),
                      opt=AdamWState(step=state.opt.step, m=full(state.opt.m),
                                     v=full(state.opt.v)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", help="smoke-size model")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.production_mesh:
        import torch.distributed as dist

        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
        if world != math.prod(PRODUCTION_SHAPE):
            _refuse(f"--production-mesh needs {' x '.join(map(str, PRODUCTION_SHAPE))} ranks "
                    f"and this run has {world}; its model axis is {PRODUCTION_SHAPE[1]}")
    made_group = ensure_process_group(device.type)
    try:
        return _train(args, device)
    finally:
        if made_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, device: torch.device):
    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = (make_production_mesh(device_type=device.type) if args.production_mesh
            else make_local_mesh(device.type))
    data_mesh(mesh)                           # refuses a model axis > 1 before allocating
    rank, world = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=device)

    pipe = TokenPipeline(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, frontend=cfg.frontend,
        frontend_len=cfg.frontend_len, d_model=cfg.d_model,
    )
    state = init_train_state(model, torch.Generator(device=device).manual_seed(0))
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        say(f"resuming from checkpoint step {start}")
        restored = ckpt.restore(start, train_state_to_reference(model, state))
        _, state = train_state_from_reference(cfg, restored, model=model)
    step_fn, state = make_sharded_train_step(model, mesh, state, AdamWConfig(lr=args.lr))

    hb = HeartbeatMonitor(n_hosts=world)
    straggler = StragglerMitigator(n_hosts=world)
    losses = []
    for step_i in range(start, args.steps):
        t0 = time.time()
        state, metrics = step_fn(state, pipe.batch_at(step_i))
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        hb.beat(rank)
        straggler.record(rank, dt)
        for ev in hb.check(step_i) + straggler.check(step_i):
            say(f"  !! fault event: {ev}")
        if step_i % 5 == 0 or step_i == args.steps - 1:
            say(f"step {step_i:4d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} {dt*1e3:7.1f} ms")
        if ckpt and (step_i + 1) % args.ckpt_every == 0:
            whole = full_state(state)
            if rank == 0:
                ckpt.save_async(step_i + 1, train_state_to_reference(model, whole))
            del whole
    if ckpt:
        ckpt.wait()
    if losses:
        say(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    else:
        say(f"nothing to do: resumed at step {start} >= {args.steps}")
    return losses


if __name__ == "__main__":
    main()
