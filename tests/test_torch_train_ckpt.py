"""Training checkpoints across the two packages, and the port's train CLI,
on the CPU.

A ``TrainState`` is saved under the keys ``jax.tree_util`` gives a
``NamedTuple``'s fields (``.params/embed``, ``.opt/.step``,
``.opt/.m/layers/attn/wq``); the port's trees go through
``carry.train_state_to_reference`` (the reference's nested, layer-stacked
layout) and back through ``carry.train_state_from_reference``.  Leaves are
fp32 (and the int32 step), so they round-trip bit for bit.
"""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import Checkpointer as RefCheckpointer
from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.train import TrainState as RefTrainState
from repro.train import adamw_init as ref_adamw_init
from repro_torch import carry
from repro_torch.ckpt import Checkpointer
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

ARCH = "olmoe-1b-7b"      # MoE: the router and the experts' (E, ...) weights


def _cfgs(arch=ARCH):
    return (dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _ref_init_train_state():
    """The reference's ``init_train_state(model, PRNGKey(0))``, its init jitted."""
    ref_cfg, _ = _cfgs()
    params = jax.jit(RefModel(ref_cfg).init)(jax.random.PRNGKey(0))
    return RefTrainState(params=params, opt=ref_adamw_init(params))


@pytest.fixture(scope="module")
def ref_state():
    state = _ref_init_train_state()
    # non-zero moments and step, so that a mix-up of m, v or step shows
    m = jax.tree.map(lambda a: a + 0.25, state.opt.m)
    v = jax.tree.map(lambda a: a + 0.5, state.opt.v)
    return state._replace(opt=state.opt._replace(step=state.opt.step + 3, m=m, v=v))


def _trained_port_state():
    _, cfg = _cfgs()
    model = Model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)}
    state, _ = make_train_step(model, AdamWConfig(lr=1e-3))(state, batch)
    return cfg, model, state


def test_train_state_keys_equal_jax(ref_state):
    _, cfg = _cfgs()
    model, state = carry.train_state_from_reference(cfg, jax.tree.map(np.asarray, ref_state),
                                                    device="cpu")
    port = [k for k, _ in _flatten(carry.train_state_to_reference(model, state))]
    assert port == [k for k, _ in ref_flatten(ref_state)]
    assert port[0] == ".params/embed" and ".opt/.step" in port and \
        ".opt/.m/layers/ffn/router" in port


def test_reference_train_state_restores_in_port(tmp_path, ref_state):
    RefCheckpointer(str(tmp_path)).save(7, ref_state)
    _, cfg = _cfgs()
    model = Model(cfg, device="cpu")
    template = carry.train_state_to_reference(
        model, init_train_state(model, torch.Generator().manual_seed(0)))
    restored = Checkpointer(str(tmp_path)).restore(7, template)
    ref_leaves = ref_flatten(jax.tree.map(np.asarray, ref_state))
    got = _flatten(restored)
    assert [k for k, _ in got] == [k for k, _ in ref_leaves]
    for (k, a), (_, b) in zip(got, ref_leaves):
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # and into a trainable model and a port TrainState, bit for bit
    model, state = carry.train_state_from_reference(cfg, restored, model=model)
    assert int(state.opt.step) == 3
    back = _flatten(carry.train_state_to_reference(model, state))
    for (k, a), (_, b) in zip(back, ref_leaves):
        assert np.array_equal(np.asarray(a), b), k


def test_port_train_state_restores_in_reference(tmp_path, ref_state):
    cfg, model, state = _trained_port_state()
    tree = carry.train_state_to_reference(model, state)
    Checkpointer(str(tmp_path)).save(2, tree)
    restored = RefCheckpointer(str(tmp_path)).restore(2, ref_state)
    assert int(restored.opt.step) == 1
    mine = _flatten(tree)
    theirs = ref_flatten(jax.tree.map(np.asarray, restored))
    assert [k for k, _ in mine] == [k for k, _ in theirs]
    for (k, a), (_, b) in zip(mine, theirs):
        assert np.array_equal(np.asarray(a), b), k
    manifest = json.load(open(os.path.join(tmp_path, "step_00000002", "manifest.json")))
    assert all(v["dtype"] in ("float32", "int32") for v in manifest["leaves"].values())


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    """The reference's slow end-to-end test, at a size that keeps it fast."""
    argv = ["--arch", "hymba-1.5b", "--reduced", "--steps", "8", "--seq-len", "32",
            "--batch", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
            "--device", "cpu"]
    losses = train.main(argv)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert Checkpointer(str(tmp_path)).steps() == [4, 8]
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "final loss" in out
    assert train.main(argv) == []          # already complete -> clean resume path
    assert "resuming from checkpoint step 8" in capsys.readouterr().out
    # a resume from step 4 continues with the same losses
    shutil.rmtree(os.path.join(tmp_path, "step_00000008"))
    assert train.main(argv) == pytest.approx(losses[4:], rel=1e-5)


def test_train_cli_production_mesh_raises():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train.main(["--production-mesh", "--reduced", "--device", "cpu"])


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1"])
