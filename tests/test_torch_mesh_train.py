"""The port's meshes and data-parallel train step, on the CPU.

* ``make_sharded_train_step`` on a 2-process gloo group over a (2, 1)
  mesh (``tcp://localhost``), gemma2-2b and olmoe-1b-7b (MoE) reduced in
  fp32, batches of 4: two steps equal two one-process ``make_train_step``
  steps on the whole batch within 1e-5 (the loss, the grad norm, every
  parameter and both moments); and on batches whose first row ignores 5
  labels (so the ranks' token counts differ) two steps equal two of the
  reference's ``jax.jit(make_train_step)`` on the whole batch, from the
  same state, within ``test_torch_train``'s bands (the loss within 1e-5
  relative, the moments within 1e-4 of each leaf's largest value, the
  params within 2 x lr a step: a first Adam step moves a weight by about
  lr x the sign of its gradient, which rounding can flip where the
  gradient is near 0).  The MoE case holds the load-balance loss
  to the whole batch's routing, not the mean of the ranks' own;
* on a (1, 2) mesh over a fake group, ``data_mesh`` is the 1-rank data
  sub-mesh, and ``make_sharded_train_step`` sets ``model.model_axis`` and
  cuts every parameter and moment to its block under
  ``dist.sharding``'s placements (the model axis's step is held to the
  one-process step in ``test_torch_tp_train.py`` and
  ``test_torch_tp_families.py``);
* ``make_local_mesh`` in one process without ``torchrun`` makes a 1-rank
  group itself; importing the mesh module makes none; the production
  meshes on a fake group have the reference's shapes and axis names.
"""
import dataclasses
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import TrainState as RefTrainState
from repro.train import make_train_step as ref_make_train_step
from repro.train import schedule as ref_schedule
from repro.train.optimizer import AdamWState as RefAdamWState
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.dist.sharding import local_shard, param_sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.train import data_mesh, full_state, make_sharded_train_step
from repro_torch.models import Model
from repro_torch.train import AdamWConfig, init_train_state, make_train_step, schedule

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("gemma2-2b", "olmoe-1b-7b")
LR = 1e-3
OPT = AdamWConfig(lr=LR)
STEPS, BATCH, SEQ = 2, 4, 16


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _batches(arch, uneven=False):
    """STEPS batches; ``uneven``: the first row ignores its last 5 labels,
    so rank 0's rows hold fewer tokens than rank 1's."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, _cfg(arch).vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
        labels = toks[:, 1:].copy()
        if uneven:
            labels[0, -5:] = -1
        out.append({"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(labels)})
    return out


def _numpy(state, metrics):
    return ({f"{part}.{k}": t.detach().numpy().copy()
             for part, tree in (("p", state.params), ("m", state.opt.m), ("v", state.opt.v))
             for k, t in tree.items()},
            [{k: float(v) for k, v in m.items()} for m in metrics])


def _worker(rank, world, port, arch, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = mesh_mod.make_local_mesh("cpu")
        runs = []
        for uneven in (False, True):
            model = Model(_cfg(arch), device="cpu")
            state = init_train_state(model, torch.Generator().manual_seed(0))
            step, state = make_sharded_train_step(model, mesh, state, OPT, schedule.constant)
            metrics = []
            for batch in _batches(arch, uneven):
                state, met = step(state, batch)
                metrics.append(met)
            runs.append(_numpy(full_state(model, state), metrics))
        if rank == 0:
            queue.put(runs)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_SHARDED = {}


def _sharded(arch, uneven=False):
    """A 2-process sharded run's final state (numpy, by port name) and
    metrics, on ``_batches(arch, uneven)``: both runs made once per arch."""
    if arch not in _SHARDED:
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        port = _free_port()
        procs = [ctx.Process(target=_worker, args=(r, 2, port, arch, queue), daemon=True)
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            _SHARDED[arch] = queue.get(timeout=240)
            for p in procs:
                p.join(timeout=60)
                assert p.exitcode == 0
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
    return _SHARDED[arch][uneven]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_one_process_step(arch):
    got, got_met = _sharded(arch)
    model = Model(_cfg(arch), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, OPT, schedule.constant)
    metrics = []
    for batch in _batches(arch):
        state, met = step(state, batch)
        metrics.append(met)
    want, want_met = _numpy(state, metrics)
    for g, w in zip(got_met, want_met):
        for k in ("loss", "grad_norm", "ce", "aux", "tokens", "lr_scale"):
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-5), k
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_reference_step(arch):
    """The sharded run on uneven batches against the reference's jitted
    step on the whole batch, from the port's initial state carried into
    the reference."""
    got, got_met = _sharded(arch, uneven=True)
    model = Model(_cfg(arch), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    init = carry.train_state_to_reference(model, state)
    ref_state = RefTrainState(params=init.params, opt=RefAdamWState(
        step=init.opt.step, m=init.opt.m, v=init.opt.v))
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
    ref_step = jax.jit(ref_make_train_step(RefModel(ref_cfg), RefAdamWConfig(lr=LR),
                                           schedule=ref_schedule.constant))
    for i, batch in enumerate(_batches(arch, uneven=True)):
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


@pytest.fixture
def fake_group():
    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_sharded_step_on_a_model_axis_cuts_each_weight_to_its_block(fake_group):
    """On a (1, 2) mesh over a fake group (rank 0 of 2): ``data_mesh`` is
    the 1-rank data sub-mesh, and ``make_sharded_train_step`` sets
    ``model.model_axis`` and leaves every parameter and both its moments
    with the shape of its block under ``param_sharding``'s placements."""
    fake_group(2)
    mesh = mesh_mod.make_custom_mesh(1, 2, device_type="cpu")
    dmesh = data_mesh(mesh)
    assert dmesh.ndim == 1 and dmesh.size() == 1 and dmesh.mesh_dim_names == ("data",)
    model = Model(_cfg(ARCHS[0]), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    whole = {k: p.detach().clone() for k, p in model.named_parameters()}
    placements = param_sharding(mesh, whole)
    _, state = make_sharded_train_step(model, mesh, state, OPT, schedule.constant)
    assert model.model_axis is not None and model.model_axis.n == 2
    assert model.model_axis.rank == 0 and model.model_axis.dims
    assert set(state.params) == set(whole)
    for k, t in whole.items():
        want = tuple(local_shard(t, placements[k], (1, 2), (0, 0)).shape)
        cut = k in model.model_axis.dims
        assert (want != t.shape) == cut, k
        for tree in (state.params, state.opt.m, state.opt.v):
            got = tree[k].to_local() if hasattr(tree[k], "to_local") else tree[k]
            assert tuple(got.shape) == want, k


def test_production_meshes_on_a_fake_group(fake_group):
    fake_group(256)
    m = mesh_mod.make_production_mesh(device_type="cpu")
    assert tuple(m.shape) == (16, 16) and m.mesh_dim_names == ("data", "model")
    dist.destroy_process_group()
    fake_group(512)
    m = mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")
    assert tuple(m.shape) == (2, 16, 16) and m.mesh_dim_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        mesh_mod.make_custom_mesh(16, 16, device_type="cpu")


def test_local_mesh_makes_a_one_rank_group():
    assert not dist.is_initialized()
    made = mesh_mod.ensure_process_group("cpu")
    try:
        assert made and dist.get_world_size() == 1
        m = mesh_mod.make_local_mesh("cpu")
        assert tuple(m.shape) == (1, 1) and m.mesh_dim_names == ("data", "model")
        assert not mesh_mod.ensure_process_group("cpu")
    finally:
        dist.destroy_process_group()


def test_importing_the_launch_tools_makes_no_group_and_loads_no_jax():
    """The new modules import without a process group, jax or ``repro``."""
    code = ("import sys, torch.distributed as dist\n"
            "import repro_torch.launch, repro_torch.launch.mesh, repro_torch.launch.train\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.report\n"
            "import repro_torch.launch.roofline, repro_torch.launch.analytics\n"
            "import repro_torch.dist.sharding, repro_torch.configs.paper_ann\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == 'repro' or m.startswith('jax')]\n"
            "print(dist.is_initialized(), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False []"
