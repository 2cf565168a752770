"""Multi-device dry-run: every (architecture x input shape) on the
production meshes, with fake tensors only (nothing allocated, nothing
launched).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape decode_32k --mesh single

Port of ``repro/launch/dryrun.py`` with its flags and record keys.  One
process stands in for every device of the mesh through the fake process
group (``torch.testing._internal.distributed.fake_pg``, a private module,
imported only here), made for each cell and torn down after it.  Per cell:

* ``memory_analysis.argument_bytes`` (exact): one device's bytes of every
  input of the step under the ``dist.sharding`` plan (train: params, m, v,
  step and the batch; prefill: params and the batch; decode: params, the
  cache, tokens and lengths), from the local shards of ``distribute_tensor``
  on fake tensors.  A serving model stores its weights in ``cfg.dtype``
  (bf16), a trainable one fp32 masters, as the port does;
  ``output_bytes`` likewise for the step's outputs;
* ``cost_flops``, ``cost_bytes`` and ``temp_bytes`` (traced): one
  device's step under ``FakeTensorMode`` at the cell's batch divided by
  the data axes, with ``FlopCounterMode`` (matmul FLOPs, every loop
  iteration counted: XLA's ``cost_analysis`` counts a scanned body once,
  so these differ from the reference's) and an accounting mode that sums
  the bytes every op reads and writes and the peak of the storages the
  step allocates beyond its inputs (weak references on storages, as
  ``torch.distributed._tools.mem_tracker.MemTracker`` keeps; MemTracker's
  own module tracking refuses a layer called once a microbatch).  On a
  mesh whose model axis is larger than 1 the traced device is rank 0 of
  that axis, for train, prefill and decode cells alike: the fake model is
  cut to its blocks (``dist.tensor_parallel.shard_model`` over the fake
  group's model axis), its split units run on them and its other units on
  weights gathered whole, as the train step and serving run them, and
  ``temp_scope`` names which ran split.  The model axis's all-reduces run
  on fake tensors: the accounting counts each one's buffer as read and
  written, like any op's, in ``cost_bytes`` (and the zero-padded buffers
  of a gather in ``temp_bytes``); what they cost on the wire is the
  roofline's collective term, ``analytic_cost``'s.  The data axes are
  not traced: FSDP2's gathers are not in the trace, which runs on the
  rank's whole blocks.  A fake trace
  costs seconds a layer, so a train or prefill cell of an attention model
  deeper than two periods of its layer pattern is traced at depths p and
  2p and extrapolated (``trace_depths``; a vlm model as its dense
  backbone, an encdec model with both stacks at each depth).  Recurrent families run their
  time loops in Python, one position at a time: their train or prefill
  cells past ``TRACE_MAX_RECURRENT_LEN`` positions are recorded with
  ``traced: false`` and the reason, the traced fields None;
* ``roofline`` (analytic): ``launch/analytics.py`` through
  ``launch/roofline.py``'s ``analyse`` with the H100's datasheet figures.

A vlm prefill cell's cache holds the prefix too: ``seq_len +
frontend_len`` positions, as the reference's.

Results go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``, and
the sweep is resumable (existing files are skipped unless
``--no-skip-existing``).  An architecture the port's ``Model`` refuses is
recorded with ``status: "error"`` and its exception.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import ARCH_IDS, SHAPES, get_config
from ..dist.sharding import (batch_sharding, cache_sharding, data_axes, param_sharding,
                             shard)
from ..dist.tensor_parallel import split_units
from .analytics import analytic_cost
from .roofline import analyse

RESULTS_DIR = os.path.join("results", "dryrun_torch")
# positions a recurrent (ssm, hybrid) train or prefill cell may trace: its
# time loop costs ~1e4 fake ops a position, so 32K-position cells would
# trace for hours (PERF.md gives the sweep's time on the CPU)
TRACE_MAX_RECURRENT_LEN = 512


def _should_skip(arch: str, shape: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return "pure full-attention arch: long_500k needs sub-quadratic attention (DESIGN.md §4)"
    return None


def _grad_accum(cfg, shape) -> int:
    """Microbatch count for the train cells, as the reference's."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 8192 or cfg.is_moe:
        return 4
    if cfg.d_model >= 5120 or cfg.family == "ssm":
        return 2
    return 1


def _model_flops(cfg, shape) -> float:
    """Useful FLOPs: 6*N*D train (fwd+bwd), 2*N*D inference fwd."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _prefill_len(cfg, shape) -> int:
    """The cache length of a prefill cell: a vlm model's prefix comes
    before the prompt."""
    return shape.seq_len + (cfg.frontend_len if cfg.family == "vlm" else 0)


def _untraced_reason(cfg, shape) -> Optional[str]:
    if cfg.family in ("ssm", "hybrid") and shape.kind != "decode" \
            and shape.seq_len > TRACE_MAX_RECURRENT_LEN:
        return (f"{cfg.family} family: its time loop runs one position at a time in Python; "
                f"{shape.seq_len} positions is past the trace cut of {TRACE_MAX_RECURRENT_LEN}")
    return None


def mesh_tag(multi_pod: bool, mesh_shape=None, kv_int8: bool = False) -> str:
    tag = (f"{mesh_shape[0]}x{mesh_shape[1]}" if mesh_shape
           else ("2x16x16" if multi_pod else "16x16"))
    return tag + ("_kvint8" if kv_int8 else "")


def _fake_mesh(multi_pod: bool, mesh_shape):
    """A fake process group of the mesh's size and the mesh over it (on
    the CPU: nothing is placed on any device)."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # a private module: say what is missing
        raise RuntimeError("the dry-run needs torch.testing._internal.distributed.fake_pg "
                           "(the fake process group), which this torch does not have") from e
    from .mesh import make_custom_mesh, make_production_mesh

    chips = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod else 256)
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own (fake) process group; one exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=chips)
    if mesh_shape is not None:
        return make_custom_mesh(*mesh_shape, device_type="cpu")
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_bytes(mesh, tensors, placement_tree) -> int:
    """One device's bytes of ``tensors`` distributed by their placements."""
    return sum(t.to_local().nbytes for t in _tensors(shard(mesh, tensors, placement_tree)))


class _Accounting(TorchDispatchMode):
    """Bytes accessed and the peak of live bytes over a trace.  Every op
    adds the bytes of its tensor arguments and results (a view moves
    nothing and counts nothing), the counterpart of XLA's ``bytes
    accessed``.  Every storage an op creates counts as live from then until
    it is freed (a weak reference on it, as ``MemTracker`` keeps); the
    storages of ``held`` (the step's inputs) count nothing."""

    def __init__(self, held):
        super().__init__()
        self.accessed = self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in held:
            self._seen[t.untyped_storage()] = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.accessed += sum(t.nbytes for t in tree_leaves((args, kwargs, out))
                                 if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self._seen:
                    self._seen[st] = n = st.nbytes()
                    self.live += n
                    weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _trace_at(cfg, shape, mesh=None) -> Dict[str, float]:
    """The step of ``shape`` (its batch the traced device's rows) on a fake
    ``Model(cfg)`` under the flop counter and :class:`_Accounting`: its
    flops, bytes accessed and temp bytes (the peak of what it allocates
    beyond the model's weights and the step's inputs).  With ``mesh`` (a
    mesh over the fake process group) and a model axis larger than 1, the
    model is first cut to rank 0's blocks of it
    (``dist.tensor_parallel.shard_model``), so the trace is that rank's
    step: split units on its blocks, gathered units whole, the model
    axis's all-reduces on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..dist.tensor_parallel import shard_model
    from ..models.model import Model
    from ..train.optimizer import AdamWConfig, adamw_init
    from ..train.train_step import TrainState, make_train_step

    with FakeTensorMode() as mode:
        model = Model(cfg, device="cpu")
        if shape.kind == "train":
            model.trainable()
        if mesh is not None and dict(zip(mesh.mesh_dim_names, mesh.shape))["model"] > 1:
            shard_model(model, mesh.get_group("model"))
        specs = model.input_specs(shape, mode)
        if shape.kind == "train":
            params = dict(model.named_parameters())
            state = TrainState(params=params, opt=adamw_init(params))
            # the microbatches split the device's rows (fewer when it has
            # fewer rows than the reference's count)
            step = make_train_step(model, AdamWConfig(), grad_accum=math.gcd(
                _grad_accum(cfg, shape), shape.global_batch))
            inputs = {"m": state.opt.m, "v": state.opt.v, **specs}
            fn = lambda: step(state, specs["batch"])  # noqa: E731
        elif shape.kind == "prefill":
            inputs = specs
            fn = lambda: model.prefill(specs["batch"], _prefill_len(cfg, shape))  # noqa: E731
        else:
            inputs = specs
            fn = lambda: model.decode_step(specs["cache"], specs["tokens"],  # noqa: E731
                                           specs["lengths"])
        flops = FlopCounterMode(display=False)
        acc = _Accounting([*model.parameters(), *_tensors(inputs)])
        with flops, acc:
            fn()
    return {"flops": float(flops.get_total_flops()), "bytes": float(acc.accessed),
            "temp": float(acc.peak)}


def _trace_depths(cfg, shape) -> Optional[tuple]:
    """(p, 2p) for a train or prefill cell of an attention family deeper
    than 2p layers, p the period of its layer pattern (gemma2's
    local/global pairs: 2); None to trace every layer.  An encdec model
    is traced with both stacks at each depth, so its two stacks must be
    equally deep to be extrapolated."""
    p = 2 if cfg.layer_pattern == "local_global" else 1
    if shape.kind == "decode" or cfg.family in ("ssm", "hybrid") or cfg.n_layers <= 2 * p:
        return None
    if cfg.is_encdec and cfg.n_enc_layers != cfg.n_layers:
        return None
    return p, 2 * p


def _at_depth(cfg, n: int):
    """``cfg`` with n decoder layers (and n encoder layers if encdec)."""
    return dataclasses.replace(cfg, n_layers=n, **({"n_enc_layers": n} if cfg.is_encdec else {}))


def _traced(cfg, shape, mesh=None) -> Dict[str, Any]:
    """The traced fields of a cell (one rank of ``mesh``'s model axis,
    :func:`_trace_at`): every layer traced, or (train and prefill cells of
    deep attention models, whose fake trace costs seconds a layer) the
    traces at depths p and 2p extrapolated to the model's depth, every
    layer of a period (an encdec model's decoder and encoder layer
    together) costing what the second period did."""
    depths = _trace_depths(cfg, shape)
    if depths is None:
        return {**_trace_at(cfg, shape, mesh), "trace_depths": [cfg.n_layers]}
    lo, hi = (_trace_at(_at_depth(cfg, n), shape, mesh) for n in depths)
    periods = (cfg.n_layers - depths[0]) / (depths[1] - depths[0])
    out = {k: lo[k] + periods * (hi[k] - lo[k]) for k in lo}
    return {**out, "trace_depths": list(depths)}


def _model_scope(cfg, n_model: int) -> str:
    """What of the model axis the traced device runs, for ``temp_scope``."""
    if n_model == 1:
        return " with every weight whole (a model axis of 1)"
    split = split_units(cfg, n_model)
    units = ["attn"] if cfg.family != "ssm" else []
    if cfg.is_moe:
        units.append("experts")
    if cfg.d_ff > 0 and (not cfg.is_moe or cfg.moe_shared_expert):
        units.append("mlp")
    ran = [f"{u} {'split' if split[u] else 'replicated'}" for u in units + ["vocab"]]
    if cfg.family in ("hybrid", "ssm"):
        ran.append("recurrences replicated")
    return (f"; rank 0 of the model axis ({n_model}) traced on its blocks of the cut weights: "
            f"{', '.join(ran)} (a replicated unit's cut weights gathered whole before use), "
            "the axis's all-reduces on fake tensors")


def _state_bytes(p_bytes: int) -> int:
    """A train state's bytes from its params': params, m and v fp32, one
    placement each; the step a 0-d int32."""
    return 3 * p_bytes + 4


def train_state_bytes(cfg, mesh_shape) -> int:
    """One device's bytes of ``cfg``'s training state (fp32 params, m and
    v, the int32 step) under the ``dist.sharding`` plan on a mesh of
    ``mesh_shape`` (data, model): a train cell's ``argument_bytes`` less
    its batch's, without tracing the step (fake tensors over a fake group,
    made and torn down here)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.model import Model

    mesh = _fake_mesh(False, mesh_shape)
    try:
        with FakeTensorMode():
            params = dict(Model(cfg, device="cpu").trainable().named_parameters())
            return _state_bytes(_local_bytes(mesh, params, param_sharding(mesh, params)))
    finally:
        dist.destroy_process_group()


def lower_cell(arch: str, shape_name: str, multi_pod: bool, mesh_shape=None,
               kv_int8: bool = False) -> Dict[str, Any]:
    """One dry-run cell (the reference's name for it kept): the record of
    ``arch`` x ``shape_name`` on the mesh, with nothing allocated."""
    cfg = get_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    return cell_record(cfg, SHAPES[shape_name], multi_pod, mesh_shape, arch=arch)


def cell_record(cfg, shape, multi_pod: bool = False, mesh_shape=None,
                arch: Optional[str] = None) -> Dict[str, Any]:
    """The dry-run record of any config and ``ShapeSpec`` on the
    production mesh (``multi_pod``) or a (data, model) ``mesh_shape``."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.model import Model

    arch = arch or cfg.name
    b, s = shape.global_batch, shape.seq_len
    t0 = time.time()
    mesh = _fake_mesh(multi_pod, mesh_shape)
    try:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        chips = math.prod(mesh.shape)
        n_data = math.prod(sizes[a] for a in data_axes(mesh))
        n_model = sizes["model"]
        with FakeTensorMode() as mode:
            model = Model(cfg, device="cpu")
            if shape.kind == "train":
                model.trainable()
            params = dict(model.named_parameters())
            p_bytes = _local_bytes(mesh, params, param_sharding(mesh, params))
            specs = model.input_specs(shape, mode)
            if shape.kind == "decode":
                inputs = {k: specs[k] for k in ("tokens", "lengths")}
                in_bytes = _local_bytes(mesh, inputs, batch_sharding(mesh, inputs, b))
                c_bytes = _local_bytes(mesh, specs["cache"],
                                       cache_sharding(mesh, specs["cache"], b))
                args_b = p_bytes + c_bytes + in_bytes
                out_b = b * cfg.vocab_size * 4 + c_bytes      # logits (replicated), cache
            else:
                batch = specs["batch"]
                in_bytes = _local_bytes(mesh, batch, batch_sharding(mesh, batch, b))
                if shape.kind == "train":
                    state_b = _state_bytes(p_bytes)
                    args_b = state_b + in_bytes
                    out_b = state_b + 6 * 4                 # the state, six 0-d metrics
                else:
                    cache = model.init_cache(b, _prefill_len(cfg, shape))
                    args_b = p_bytes + in_bytes
                    out_b = b * cfg.vocab_size * 4 + _local_bytes(
                        mesh, cache, cache_sharding(mesh, cache, b))
            del model, params, specs
        t_lower = time.time() - t0
        b_loc = b // n_data if (b % n_data == 0 and b >= n_data) else b
        reason = _untraced_reason(cfg, shape)
        traced = None if reason else _traced(
            cfg, dataclasses.replace(shape, global_batch=b_loc), mesh)
    finally:
        dist.destroy_process_group()
    t_trace = time.time() - t0 - t_lower

    mf = _model_flops(cfg, shape)
    ac = analytic_cost(cfg, shape, n_data=chips // n_model, n_model=n_model)
    cost = {"flops": traced["flops"], "bytes accessed": traced["bytes"]} if traced else {}
    terms = analyse(cost, chips, model_flops=mf, analytic=ac)
    mem_d = {
        "argument_bytes": int(args_b),
        "output_bytes": int(out_b),
        "temp_bytes": int(traced["temp"]) if traced else None,
        "generated_code_bytes": 0,
    }
    result = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_tag(multi_pod, mesh_shape),
        "chips": chips,
        "status": "ok",
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_trace, 2),
        "memory_analysis": mem_d,
        "cost_flops": traced["flops"] if traced else None,
        "cost_bytes": traced["bytes"] if traced else None,
        "roofline": terms.to_dict(),
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "model_flops": mf,
        "traced": traced is not None,
        "trace_batch": b_loc,
        "trace_depths": traced["trace_depths"] if traced else None,
        "temp_scope": (f"one device traced at batch {b_loc} (the global batch over the data "
                       f"axes)" + _model_scope(cfg, n_model)
                       + ("" if not traced or traced["trace_depths"] == [cfg.n_layers] else
                          f"; extrapolated to {cfg.n_layers} layers from traces at depths "
                          f"{traced['trace_depths']}")),
    }
    if reason:
        result["reason"] = reason
    tb = mem_d["temp_bytes"]
    print(f"[{arch} x {shape.name} x {result['mesh']}] OK "
          f"plan {t_lower:.1f}s trace {t_trace:.1f}s | "
          + (f"flops {traced['flops']:.3g} bytes {traced['bytes']:.3g} | " if traced
             else "not traced | ")
          + f"args {args_b / 2**30:.2f} GiB/dev | coll {terms.coll_bytes:.3g}B | "
          f"bottleneck {terms.bottleneck} | "
          + (f"temp {tb / 2**30:.2f} GiB/dev" if tb is not None else "temp not traced"))
    return result


def run_cell(arch, shape_name, multi_pod, out_dir, skip_existing=True,
             mesh_shape=None, kv_int8=False):
    tag = mesh_tag(multi_pod, mesh_shape, kv_int8)
    fn = os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json")
    if skip_existing and os.path.exists(fn):
        print(f"[{arch} x {shape_name} x {tag}] cached")
        with open(fn) as f:
            return json.load(f)
    reason = _should_skip(arch, shape_name)
    if reason:
        result = {
            "arch": arch, "shape": shape_name, "mesh": tag,
            "status": "skipped", "reason": reason,
        }
        print(f"[{arch} x {shape_name} x {tag}] SKIP: {reason}")
    else:
        try:
            result = lower_cell(arch, shape_name, multi_pod,
                                mesh_shape=mesh_shape, kv_int8=kv_int8)
        except Exception as e:  # noqa — record the failure, keep sweeping
            result = {
                "arch": arch, "shape": shape_name, "mesh": tag,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            print(f"[{arch} x {shape_name} x {tag}] ERROR: {e}")
    os.makedirs(out_dir, exist_ok=True)
    with open(fn, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--mesh-shape", default=None,
                    help="custom DATAxMODEL single-pod mesh, e.g. 32x8")
    ap.add_argument("--kv-int8", action="store_true",
                    help="quantised int8 KV cache (serving hillclimb)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--no-skip-existing", action="store_true")
    args = ap.parse_args(argv)
    mesh_shape = (
        tuple(int(x) for x in args.mesh_shape.split("x")) if args.mesh_shape else None
    )

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_fail = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes if mesh_shape is None else [False]:
                r = run_cell(arch, shape, mp, args.out,
                             skip_existing=not args.no_skip_existing,
                             mesh_shape=mesh_shape, kv_int8=args.kv_int8)
                if r.get("status") == "error":
                    n_fail += 1
    print(f"dry-run sweep done in {time.time() - t0:.1f} s; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
