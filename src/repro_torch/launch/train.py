"""End-to-end training from the command line.

Port of ``repro/launch/train.py`` with the same flags and prints, plus
``--device`` (default ``cuda``; pass ``cpu`` to run without a card):

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 50 \\
        --reduced --ckpt-dir /tmp/ckpt

Wires together: config registry -> model (fp32 masters) -> train step ->
deterministic data pipeline -> checkpointing (async, atomic, auto-resume) ->
fault hooks (heartbeat + straggler monitors).  One process drives one
device; the reference's device mesh (``--production-mesh``) is not ported
yet.  Checkpoints hold the state in the reference's layout
(``carry.train_state_to_reference``), so either package's CLI resumes
the other's.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..carry import train_state_from_reference, train_state_to_reference
from ..ckpt.checkpoint import Checkpointer
from ..configs import get_config
from ..data.pipeline import TokenPipeline
from ..device import resolve_device
from ..dist.fault import HeartbeatMonitor, StragglerMitigator
from ..models.model import Model
from ..train.optimizer import AdamWConfig
from ..train.train_step import init_train_state, make_train_step


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

    if args.production_mesh:
        raise NotImplementedError(
            f"--production-mesh: the device mesh and parameter sharding "
            "(dist/sharding.py) are not ported to repro_torch yet (ROADMAP Queue 1 item 13.2)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=device)

    pipe = TokenPipeline(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, frontend=cfg.frontend,
        frontend_len=cfg.frontend_len, d_model=cfg.d_model,
    )
    step_fn = make_train_step(model, AdamWConfig(lr=args.lr))
    state = init_train_state(model, torch.Generator(device=device).manual_seed(0))
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        print(f"resuming from checkpoint step {start}")
        restored = ckpt.restore(start, train_state_to_reference(model, state))
        _, state = train_state_from_reference(cfg, restored, model=model)

    hb = HeartbeatMonitor(n_hosts=1)
    straggler = StragglerMitigator(n_hosts=1)
    losses = []
    for step_i in range(start, args.steps):
        t0 = time.time()
        state, metrics = step_fn(state, pipe.batch_at(step_i))
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        hb.beat(0)
        straggler.record(0, dt)
        for ev in hb.check(step_i) + straggler.check(step_i):
            print(f"  !! fault event: {ev}")
        if step_i % 5 == 0 or step_i == args.steps - 1:
            print(f"step {step_i:4d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} {dt*1e3:7.1f} ms")
        if ckpt and (step_i + 1) % args.ckpt_every == 0:
            ckpt.save_async(step_i + 1, train_state_to_reference(model, state))
    if ckpt:
        ckpt.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    else:
        print(f"nothing to do: resumed at step {start} >= {args.steps}")
    return losses


if __name__ == "__main__":
    main()
