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

:func:`make_sharded_train_step` is the reference's ``jax.jit(step,
in_shardings=...)`` over any mesh: every weight and moment is held where
``dist.sharding`` puts it.  On the model axis ``dist.tensor_parallel``
cuts the weights and splits the compute (all-reduce only); over the data
axes FSDP2 shards the blocks, one unit a decoder layer (or xLSTM group or
encoder layer) and one at the root, each on the dim where the rules put
the data axes, and the weights the rules replicate there stay whole on
every rank.  Checkpoints hold full tensors in the reference's layout
(``full_state`` -> ``carry.train_state_to_reference``), so either
package's CLI resumes the other's, on any mesh.
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
from ..dist.sharding import data_axes, param_sharding
from ..dist.tensor_parallel import shard_model
from ..models.model import Model
from ..train import schedule as schedules
from ..train.optimizer import AdamWConfig, AdamWState
from ..train.train_step import TrainState, init_train_state, make_train_step
from .mesh import PRODUCTION_SHAPE, ensure_process_group, make_local_mesh, make_production_mesh

__all__ = ["make_sharded_train_step", "data_mesh", "full_state", "main"]


def data_mesh(mesh):
    """The 1-D mesh over ``mesh``'s data axes (flattened when there are
    several), which FSDP2 shards over."""
    axes = data_axes(mesh)
    return mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()


def _data_placements(mesh, model: Model) -> Dict[str, object]:
    """Each parameter's placement over the data axes, from
    ``dist.sharding``'s rules on its whole shape: ``Shard(d)`` where they
    put the data axes on dim d (the input dim of a column-parallel weight,
    the output dim of a row-parallel one), None where they replicate it
    (norm scales, the embedding, a dim the data axes do not divide)."""
    from torch.distributed.tensor import Shard

    d_dims = [i for i, a in enumerate(mesh.mesh_dim_names) if a != "model"]
    out = {}
    for name, placement in param_sharding(mesh, dict(model.named_parameters())).items():
        on_data = [placement[i] for i in d_dims]
        out[name] = on_data[0] if all(isinstance(p, Shard) for p in on_data) else None
    return out


def make_sharded_train_step(model: Model, mesh, state: TrainState,
                            opt_cfg: AdamWConfig = AdamWConfig(),
                            schedule: Callable = schedules.warmup_cosine,
                            grad_accum: int = 1) -> Tuple[Callable, TrainState]:
    """Place ``model`` and ``state`` (full tensors, the same on every rank:
    ``init_train_state``'s, or a restored checkpoint's) where
    ``dist.sharding`` puts them on ``mesh``.  A model axis larger than 1
    cuts each weight and moment to this rank's block and splits the
    compute over its group (``dist.tensor_parallel.shard_model``,
    ``Model.model_group``); FSDP2 then shards the blocks over the data
    axes, and the weights the rules replicate there stay whole.  Returns
    ``(train_step, sharded_state)``: ``train_step`` is
    ``make_train_step``'s over the data axes' process group, which takes
    the GLOBAL batch, every rank the same, and gives the one-process step's
    update of the whole batch."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import distribute_tensor

    dmesh = data_mesh(mesh)
    on_data = _data_placements(mesh, model)
    axis = None
    if dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1) > 1:
        axis = shard_model(model, mesh["model"].get_group())
    named = dict(model.named_parameters())
    by_id = {id(p): on_data[k] for k, p in named.items()}
    kept = {p for k, p in named.items() if on_data[k] is None}
    units = list(model.blocks if model.cfg.family == "ssm" else model.layers)
    if model.cfg.is_encdec:
        units += list(model.enc_layers)
    for unit in units + [model]:
        fully_shard(unit, mesh=dmesh, shard_placement_fn=lambda p: by_id.get(id(p)),
                    ignored_params=kept)
    register_fsdp_forward_method(model, "loss")
    params = dict(model.named_parameters())

    def moments(full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, p in params.items():
            t = full[k].detach().to(p.device, torch.float32)
            # a copy of this rank's block: no view keeps the whole tensor alive
            t = (axis.block(t, k) if axis is not None else t).clone()
            out[k] = (distribute_tensor(t, dmesh, p.placements, src_data_rank=None)
                      if hasattr(p, "placements") else t)
        return out

    sharded = TrainState(params=params, opt=AdamWState(
        step=state.opt.step, m=moments(state.opt.m), v=moments(state.opt.v)))
    return make_train_step(model, opt_cfg, schedule, grad_accum, group=dmesh.get_group()), sharded


def full_state(model: Model, state: TrainState) -> TrainState:
    """``make_sharded_train_step``'s state of ``model`` with every tensor
    gathered whole over the data axes and the model axis
    (``model.model_axis``; a collective: every rank calls it)."""
    axis = model.model_axis

    def full(tree):
        out = {}
        for k, t in tree.items():
            t = t.full_tensor() if hasattr(t, "full_tensor") else t
            out[k] = axis.whole(t, k) if axis is not None else t
        return out

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
            raise ValueError(f"--production-mesh needs {math.prod(PRODUCTION_SHAPE)} ranks "
                             f"({' x '.join(map(str, PRODUCTION_SHAPE))}); this run has {world}")
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
            whole = full_state(model, state)
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
