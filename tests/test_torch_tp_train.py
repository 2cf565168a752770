"""The port's tensor-parallel train step (a mesh whose model axis is larger
than 1), on the CPU.

Each mesh is a gloo group over ``tcp://localhost`` (one spawned process
a rank), the models reduced configs in fp32, batches of 4 x 16, two steps
of AdamW at lr 1e-3.  Every case of a mesh runs in one spawn:

* gemma2-2b (the tied, vocab-parallel head, softcaps, windows) and
  olmoe-1b-7b (expert-parallel, qk norms) at (2, 2): two steps equal two
  one-process ``make_train_step`` steps on the whole batch (``hold``);
  and, on batches whose first row ignores 5 labels (the data ranks' token
  counts differ), two of the reference's ``jax.jit(make_train_step)``
  steps within ``test_torch_train``'s bands;
* at (2, 2) each rank's block of every leaf has the shape
  ``dist.sharding.param_sharding`` gives it, and its state bytes (params,
  m, v, the step) equal the dry-run's ``argument_bytes`` less the batch's;
* at (1, 2) one rank's forward counts at most 0.6 of the one-process
  forward's FLOPs (``FlopCounterMode``): the compute is split, not
  replicated;
* a state trained one step at (1, 2) and saved as the train CLI saves it
  (``full_state`` -> ``carry.train_state_to_reference`` ->
  ``Checkpointer``) resumes in one process and on a (2, 1) mesh, and the
  next step's loss equals the (1, 2) run's within 1e-5.

The band against the one-process step (``hold``): the metrics (loss, grad
norm, ce, aux, tokens) and both moments within 1e-5; every parameter
within 2 x lr a step, and at most 1 in 10,000 of a model's parameter
elements outside 1e-5.  A first Adam step moves a weight by lr x g / (|g|
+ eps): where g is within rounding of Adam's eps (1e-8), the two
summation orders give another quotient.  Observed: at most 9 of olmoe's
1.84M elements outside 1e-5 (at (2, 2)), the widest gap 8.1e-4 (an
xLSTM embedding row whose gradient was 1.7e-8, at (1, 2)).
"""
import dataclasses
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch import carry
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.dist.sharding import local_shard, param_sharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.train import full_state, make_sharded_train_step
from repro_torch.models import Model
from repro_torch.train import AdamWConfig, init_train_state, make_train_step, schedule

LR = 1e-3
OPT = AdamWConfig(lr=LR)
STEPS, BATCH, SEQ = 2, 4, 16
SPAWN_TIMEOUT = 150


def cfg_of(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def batches(arch, uneven=False, n=STEPS):
    """``n`` batches of BATCH x SEQ (stub frames or patches for a frontend
    model); ``uneven``: the first row ignores its last 5 labels."""
    cfg = cfg_of(arch)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
        labels = toks[:, 1:].copy()
        if uneven:
            labels[0, -5:] = -1
        b = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(labels)}
        if cfg.frontend != "none":
            b["patches" if cfg.family == "vlm" else "frames"] = torch.as_tensor(
                rng.standard_normal((BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32))
        out.append(b)
    return out


def to_numpy(state, metrics):
    """(the state's params and moments by "p."/"m."/"v." + name, metrics)."""
    return ({f"{part}.{k}": t.detach().numpy().copy()
             for part, tree in (("p", state.params), ("m", state.opt.m), ("v", state.opt.v))
             for k, t in tree.items()},
            [{k: float(v) for k, v in m.items()} for m in metrics])


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _local_record(state) -> dict:
    """This rank's block shape of every leaf, and its state bytes."""
    shapes = {f"{part}.{k}": tuple(_local(t).shape)
              for part, tree in (("p", state.params), ("m", state.opt.m), ("v", state.opt.v))
              for k, t in tree.items()}
    nbytes = sum(_local(t).numel() * _local(t).element_size()
                 for tree in (state.params, state.opt.m, state.opt.v) for t in tree.values())
    return {"shapes": shapes, "bytes": nbytes + state.opt.step.numel() * 4}


def run_case(mesh, job: dict) -> dict:
    """One case on this rank: a fresh model and state, sharded on
    ``mesh``, trained STEPS steps; what the tests read of it."""
    arch = job["arch"]
    model = Model(cfg_of(arch), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step, state = make_sharded_train_step(model, mesh, state, OPT, schedule.constant)
    out = {"local": _local_record(state)}
    if job.get("flops"):
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter:
            model(batches(arch, n=1)[0])
        out["flops"] = counter.get_total_flops()
    metrics = []
    for i, batch in enumerate(batches(arch, job.get("uneven", False))):
        state, met = step(state, batch)
        metrics.append(met)
        if i == 0 and job.get("ckpt"):
            whole = carry.train_state_to_reference(model, full_state(model, state))
            if dist.get_rank() == 0:
                Checkpointer(job["ckpt"]).save(1, whole)
            dist.barrier()
    out["run"] = to_numpy(full_state(model, state), metrics)
    return out


def resume_case(mesh, job: dict) -> dict:
    """The checkpoint of ``job["ckpt"]`` restored onto ``mesh`` and
    trained one step, on the second batch."""
    arch = job["arch"]
    model = Model(cfg_of(arch), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    ck = Checkpointer(job["ckpt"])
    restored = ck.restore(1, carry.train_state_to_reference(model, state))
    _, state = carry.train_state_from_reference(model.cfg, restored, model=model)
    step, state = make_sharded_train_step(model, mesh, state, OPT, schedule.constant)
    _, met = step(state, batches(arch)[1])
    return {"loss": float(met["loss"])}


def worker(rank, world, port, jobs, queue, case=None):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        try:
            meshes, out = {}, {}
            for key, job in jobs.items():
                if job["mesh"] not in meshes:
                    meshes[job["mesh"]] = mesh_mod.make_custom_mesh(*job["mesh"],
                                                                    device_type="cpu")
                fn = case or (resume_case if job.get("resume") else run_case)
                out[key] = fn(meshes[job["mesh"]], job)
            queue.put((rank, out))
        finally:
            dist.destroy_process_group()
    except Exception:
        queue.put((rank, traceback.format_exc()))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, jobs: dict, case=None) -> dict:
    """Run ``jobs`` (key -> job, in order; each on its ``"mesh"``, a
    (data, model) shape of ``world`` ranks) in ``world`` spawned gloo
    ranks, each through ``case(mesh, job)`` (a module-level function;
    default: this module's train cases); returns {rank: {key: result}}.
    A rank's exception fails the test with its traceback."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=worker, args=(r, world, port, jobs, queue, case), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        while len(out) < world:
            rank, res = queue.get(timeout=SPAWN_TIMEOUT)
            if isinstance(res, str):
                pytest.fail(f"rank {rank} of {world} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(timeout=60)
            assert p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return out


def one_process(arch, uneven=False):
    """Two one-process ``make_train_step`` steps on the whole batches."""
    model = Model(cfg_of(arch), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, OPT, schedule.constant)
    metrics = []
    for batch in batches(arch, uneven):
        state, met = step(state, batch)
        metrics.append(met)
    return to_numpy(state, metrics)


def hold(got, want) -> None:
    """The tensor-parallel run ``got`` against the one-process run
    ``want`` (each ``to_numpy``'s), in the module docstring's band."""
    (g_tree, g_met), (w_tree, w_met) = got, want
    for g, w in zip(g_met, w_met):
        for k in ("loss", "grad_norm", "ce", "aux", "tokens", "lr_scale"):
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-5), k
    assert set(g_tree) == set(w_tree)
    outside = total = 0
    for k, w in w_tree.items():
        assert g_tree[k].shape == w.shape, k
        if k.startswith("p."):
            gap = np.abs(g_tree[k] - w)
            assert float(gap.max()) <= 2 * LR * STEPS * (1 + 1e-3), (k, float(gap.max()))
            outside += int((gap > 1e-5 + 1e-5 * np.abs(w)).sum())
            total += w.size
        else:
            np.testing.assert_allclose(g_tree[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
    assert outside <= total * 1e-4, (outside, total)


ARCHS = ("gemma2-2b", "olmoe-1b-7b")
_RUNS = {}


def _runs_2x2():
    """Both archs at (2, 2) on even and uneven batches, in one spawn."""
    if "2x2" not in _RUNS:
        jobs = {(arch, uneven): {"arch": arch, "uneven": uneven, "mesh": (2, 2)}
                for arch in ARCHS for uneven in (False, True)}
        _RUNS["2x2"] = spawn(4, jobs)
    return _RUNS["2x2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_equals_one_process_step_2x2(arch):
    hold(_runs_2x2()[0][(arch, False)]["run"], one_process(arch))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_equals_reference_step_2x2(arch):
    """The (2, 2) run on uneven batches against the reference's jitted step
    on the whole batch, from the port's initial state carried into it.
    (The JAX package is imported here, not at the top: every spawned rank
    imports this module.)"""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import Model as RefModel
    from repro.train import AdamWConfig as RefAdamWConfig
    from repro.train import TrainState as RefTrainState
    from repro.train import make_train_step as ref_make_train_step
    from repro.train import schedule as ref_schedule
    from repro.train.optimizer import AdamWState as RefAdamWState

    got, got_met = _runs_2x2()[0][(arch, True)]["run"]
    model = Model(cfg_of(arch), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    init = carry.train_state_to_reference(model, state)
    ref_state = RefTrainState(params=init.params, opt=RefAdamWState(
        step=init.opt.step, m=init.opt.m, v=init.opt.v))
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
    ref_step = jax.jit(ref_make_train_step(RefModel(ref_cfg), RefAdamWConfig(lr=LR),
                                           schedule=ref_schedule.constant))
    for i, batch in enumerate(batches(arch, uneven=True)):
        ref_state, rm = ref_step(ref_state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        assert abs(got_met[i]["loss"] - float(rm["loss"])) <= 1e-5 * abs(float(rm["loss"])), i
        assert got_met[i]["tokens"] == float(rm["tokens"])
    with torch.no_grad():
        for part, tree in (("p", state.params), ("m", state.opt.m), ("v", state.opt.v)):
            for k, t in tree.items():
                t.copy_(torch.as_tensor(got[f"{part}.{k}"]))
    mine = carry.train_state_to_reference(model, state)
    ref = jax.tree.map(np.asarray, ref_state)
    for what, band, port_tree, ref_tree in (("m", 1e-4, mine.opt.m, ref.opt.m),
                                            ("v", 2e-4, mine.opt.v, ref.opt.v)):
        port_l, ref_l = dict(_leaves(port_tree)), dict(_leaves(ref_tree))
        assert set(port_l) == set(ref_l)
        for k, r in ref_l.items():
            gap = float(np.abs(port_l[k] - r).max())
            assert gap <= band * float(np.abs(r).max()), (arch, what, k, gap)
    port_l, ref_l = dict(_leaves(mine.params)), dict(_leaves(ref.params))
    for k, r in ref_l.items():
        assert float(np.abs(port_l[k] - r).max()) <= 2 * LR * STEPS * (1 + 1e-3), (arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_have_the_rules_placements_2x2(arch):
    """Each rank's block of every leaf is ``local_shard`` of the whole
    leaf under ``param_sharding``'s placements at the rank's mesh
    coordinates, and its state bytes are the dry-run's argument bytes
    less the batch's (int32 tokens and labels of its data rows)."""
    rec = dryrun.cell_record(cfg_of(arch), ShapeSpec("train", SEQ, BATCH, "train"),
                             mesh_shape=(2, 2), arch=arch)
    batch_bytes = 2 * (BATCH // 2) * SEQ * 4
    assert dryrun.train_state_bytes(cfg_of(arch), (2, 2)) == \
        rec["memory_analysis"]["argument_bytes"] - batch_bytes
    model = Model(cfg_of(arch), device="cpu").trainable()
    whole = dict(model.named_parameters())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        placements = param_sharding(mesh_mod.make_custom_mesh(2, 2, device_type="cpu"), whole)
    finally:
        dist.destroy_process_group()
    for rank, runs in _runs_2x2().items():
        local = runs[(arch, False)]["local"]
        coords = divmod(rank, 2)
        for k, t in whole.items():
            want = tuple(local_shard(t, placements[k], (2, 2), coords).shape)
            for part in "pmv":
                assert local["shapes"][f"{part}.{k}"] == want, (rank, part, k)
        assert local["bytes"] == rec["memory_analysis"]["argument_bytes"] - batch_bytes, rank


_ONE_BY_TWO = {}


def _runs_1x2(tmp_dir):
    """gemma2-2b at (1, 2): its forward under the flop counter, and a run
    that saves its state after the first step; then, in the same two
    ranks, that checkpoint resumed on a (2, 1) mesh."""
    if "run" not in _ONE_BY_TWO:
        _ONE_BY_TWO["ckpt"] = str(tmp_dir)
        _ONE_BY_TWO["run"] = spawn(2, {
            "gemma2": {"arch": "gemma2-2b", "flops": True, "ckpt": str(tmp_dir),
                       "mesh": (1, 2)},
            "resume": {"arch": "gemma2-2b", "resume": True, "ckpt": str(tmp_dir),
                       "mesh": (2, 1)}})
    return _ONE_BY_TWO


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_ckpt")


def test_one_rank_forward_counts_at_most_six_tenths_of_the_flops(ckpt_dir):
    from torch.utils.flop_counter import FlopCounterMode

    got = _runs_1x2(ckpt_dir)["run"]
    model = Model(cfg_of("gemma2-2b"), device="cpu")
    init_train_state(model, torch.Generator().manual_seed(0))
    counter = FlopCounterMode(display=False)
    with counter:
        model(batches("gemma2-2b", n=1)[0])
    whole = counter.get_total_flops()
    for rank in (0, 1):
        assert got[rank]["gemma2"]["flops"] <= 0.6 * whole, (rank, got[rank]["gemma2"]["flops"],
                                                             whole)


def test_checkpoint_saved_at_1x2_resumes_in_one_process_and_at_2x1(ckpt_dir):
    runs = _runs_1x2(ckpt_dir)
    tp_loss = runs["run"][0]["gemma2"]["run"][1][1]["loss"]
    # one process
    model = Model(cfg_of("gemma2-2b"), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    restored = Checkpointer(runs["ckpt"]).restore(1, carry.train_state_to_reference(model, state))
    _, state = carry.train_state_from_reference(model.cfg, restored, model=model)
    assert int(state.opt.step) == 1
    _, met = make_train_step(model, OPT, schedule.constant)(state, batches("gemma2-2b")[1])
    assert float(met["loss"]) == pytest.approx(tp_loss, rel=1e-5)
    # a (2, 1) mesh
    dp = runs["run"]
    assert dp[0]["resume"]["loss"] == pytest.approx(tp_loss, rel=1e-5)
    assert dp[1]["resume"]["loss"] == dp[0]["resume"]["loss"]
