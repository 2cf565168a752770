"""The port's training path against the JAX package's, on the CPU.

Held to ``repro.train`` / ``repro.models.Model.loss``:

* AdamW (``adamw_update``) on random trees, with and without clipping and
  weight decay: params, m, v and the pre-clip norm within 1e-6;
* the schedules over steps 0-300, and ``TokenPipeline`` bit for bit;
* ``Model.loss`` (``ce``, ``aux``) within 1e-5 relative and the gradients
  of every parameter within 1e-4 of the leaf's largest reference value,
  for qwen3 (dense), gemma2 (windows, softcaps, tied embeddings), olmoe
  (MoE), hymba (attention beside Mamba), xlstm (sLSTM, mLSTM),
  seamless-m4t (encdec: the encoder over stub frames, cross-attention)
  and internvl2 (vlm: stub patches before the prompt), each
  ``reduced()`` in fp32, the reference's weights carried in with
  ``carry``; some labels are -1, and qwen3 also runs S=600, whose second
  512-position cross-entropy chunk is padded;
* one train step per family from one carried ``TrainState`` (against
  the reference's ``adamw_update`` on its ``value_and_grad`` grads, the
  body of its ``make_train_step``), and three qwen3 steps against
  ``jax.jit(make_train_step)`` itself.

The reference runs as its own tests run it: ``jax.jit`` of
``jax.value_and_grad`` and of ``make_train_step``.  Grads come back
through ``carry.params_to_reference``; states through
``carry.train_state_to_reference``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import Model as RefModel
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import TrainState as RefTrainState
from repro.train import adamw_init as ref_adamw_init
from repro.train import adamw_update as ref_adamw_update
from repro.train import make_train_step as ref_make_train_step
from repro.train import schedule as ref_schedule
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import Model, layers, ssm
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update, init_train_state,
                               make_train_step, schedule)

ARCHS = ("qwen3-14b", "gemma2-2b", "olmoe-1b-7b", "hymba-1.5b", "xlstm-1.3b",
         "seamless-m4t-large-v2", "internvl2-76b")
LAYERS = {"xlstm-1.3b": 4}      # two groups of one sLSTM and one mLSTM
SEQ = {"gemma2-2b": 80}         # past its 64-token window
LOSS_RTOL = 1e-5
GRAD_BAND = 1e-4
LR = 1e-3


def _cfgs(arch):
    over = {"dtype": "float32"}
    if arch in LAYERS:
        over["n_layers"] = LAYERS[arch]
    return (dataclasses.replace(ref_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _batch(cfg, seed, b=2, s=48):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, ::7] = -1           # ignored positions
    labels[0, -5:] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend != "none":    # stub frames (encdec) or patches (vlm)
        batch["patches" if cfg.family == "vlm" else "frames"] = rng.normal(
            0, 1, (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _hold(port_tree, ref_tree, band, what):
    """Every leaf: max|port - ref| <= band * max|ref|, the same keys."""
    port, ref = dict(_leaves(port_tree)), dict(_leaves(ref_tree))
    assert set(port) == set(ref), (what, set(port) ^ set(ref))
    for k, r in ref.items():
        gap = float(np.abs(port[k] - r).max())
        assert gap <= band * float(np.abs(r).max()), f"{what} {k}: gap {gap} vs max {np.abs(r).max()}"


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


_FAMILY = {}


def _family(arch):
    """Reference model and fp32 params, the port's trainable model carrying
    them, a batch, and each package's loss metrics and grads: made once."""
    if arch not in _FAMILY:
        ref_cfg, cfg = _cfgs(arch)
        ref = RefModel(ref_cfg)
        params = jax.jit(ref.init)(jax.random.PRNGKey(0))
        batch = _batch(cfg, 1, s=SEQ.get(arch, 48))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (ref_total, ref_m), ref_g = jax.jit(
            jax.value_and_grad(lambda p: ref.loss(p, jb), has_aux=True))(params)
        port = carry.model_params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                                 device="cpu").trainable()
        total, m = port.loss(batch)
        names = [n for n, _ in port.named_parameters()]
        # an encdec model's xattn.wk/wv past layer 0 take no part (their
        # reference grads are zeros)
        grads = torch.autograd.grad(total, [p for _, p in port.named_parameters()],
                                    materialize_grads=True)
        _FAMILY[arch] = dict(ref_cfg=ref_cfg, cfg=cfg, ref=ref, params=params, batch=batch,
                             ref_total=float(ref_total), ref_g=ref_g,
                             ref_metrics=jax.tree.map(np.asarray, ref_m),
                             ref_grads=jax.tree.map(np.asarray, ref_g), port=port,
                             metrics={k: float(torch.as_tensor(v).detach()) for k, v in m.items()},
                             grads=dict(zip(names, grads)))
    return _FAMILY[arch]


# ----------------------------------------------------------------------
# optimizer, schedules, pipeline
# ----------------------------------------------------------------------
def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (16, 8)).astype(np.float32),
            "nested": {"b": rng.normal(0, 1, (8,)).astype(np.float32),
                       "c": rng.normal(0, 3, (4, 4, 2)).astype(np.float32)}}


def _flat(tree):
    return {k.replace("/", "."): v for k, v in _leaves(tree)}


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.1), (1.0, 0.0), (100.0, 0.05)])
def test_adamw_equals_reference(clip, wd):
    ref_cfg = RefAdamWConfig(lr=3e-3, clip_norm=clip, weight_decay=wd)
    cfg = AdamWConfig(lr=3e-3, clip_norm=clip, weight_decay=wd)
    params = _random_tree(0)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = ref_adamw_init(ref_p)
    port_p = {k: torch.tensor(v) for k, v in _flat(params).items()}
    port_s = adamw_init(port_p)
    for i in range(3):
        grads = _random_tree(10 + i)
        ref_p, ref_s, ref_n = ref_adamw_update(ref_p, jax.tree.map(jnp.asarray, grads), ref_s,
                                               ref_cfg, jnp.float32(0.7))
        port_p, port_s, n = adamw_update(port_p, {k: torch.tensor(v) for k, v in
                                                  _flat(grads).items()}, port_s, cfg, 0.7)
        assert _rel(n, ref_n) <= 1e-6          # the pre-clip norm
        assert int(port_s.step) == int(ref_s.step) == i + 1
        for mine, theirs in ((port_p, ref_p), (port_s.m, ref_s.m), (port_s.v, ref_s.v)):
            for k, r in _flat(jax.tree.map(np.asarray, theirs)).items():
                np.testing.assert_allclose(mine[k].numpy(), r, rtol=1e-6, atol=1e-6)


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(params, grads, state, cfg, 1.0)
    assert float(params["w"].abs().max()) < 0.1


def test_adamw_clips_gradients():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    _, _, gnorm = adamw_update(params, {"w": torch.full((4,), 1e6)}, state,
                               AdamWConfig(lr=1e-3, clip_norm=1.0), 1.0)
    assert float(gnorm) > 1e5          # reported norm is pre-clip


@pytest.mark.parametrize("kw", [{}, {"warmup": 10, "total": 100}, {"warmup": 0, "total": 50,
                                                                    "floor": 0.0}])
def test_schedules_equal_reference(kw):
    steps = np.arange(0, 301)
    ref = np.array([float(ref_schedule.warmup_cosine(int(i), **kw)) for i in steps])
    port = np.array([float(schedule.warmup_cosine(int(i), **kw)) for i in steps])
    # fp32 throughout; the packages' cos differ by one ulp (<= 6e-8) at 1-3
    # of the 301 steps, every other step is equal bit for bit
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-7)
    assert (port != ref).sum() <= 5
    # the step as a 0-d int32 tensor, as AdamWState holds it
    assert float(schedule.warmup_cosine(torch.tensor(50, dtype=torch.int32), **kw)) == port[50]
    assert [float(schedule.constant(int(i))) for i in steps] == \
        [float(ref_schedule.constant(int(i))) for i in steps]
    s = np.array([float(schedule.warmup_cosine(i, warmup=10, total=100))
                  for i in [0, 5, 10, 50, 100]])
    assert s[0] == 0.0 and s[1] < s[2] and s[2] >= s[3] >= s[4]


@pytest.mark.parametrize("frontend", ["none", "vision", "audio"])
def test_token_pipeline_bitwise(frontend):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=6, seed=3, frontend=frontend,
              frontend_len=5 if frontend != "none" else 0, d_model=16)
    ref, port = RefPipeline(**kw), TokenPipeline(**kw)
    for step in (0, 1, 17):
        for host_slice in (None, slice(2, 4)):
            a, b = port.batch_at(step, host_slice), ref.batch_at(step, host_slice)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)


# ----------------------------------------------------------------------
# the loss and its gradients, per family
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_equals_reference(arch):
    f = _family(arch)
    for k in ("ce", "aux"):
        assert _rel(f["metrics"][k], f["ref_metrics"][k]) <= LOSS_RTOL or \
            abs(f["metrics"][k] - float(f["ref_metrics"][k])) <= 1e-12, (k, f["metrics"],
                                                                         f["ref_metrics"])
    assert f["metrics"]["tokens"] == int(f["ref_metrics"]["tokens"])
    assert (f["metrics"]["aux"] > 0) == (arch == "olmoe-1b-7b")


def test_loss_padded_chunk_equals_reference():
    """S=600: chunks of 512 and 88 positions, the second padded with -1."""
    f = _family("qwen3-14b")
    batch = _batch(f["cfg"], 2, b=1, s=600)
    ref_total, ref_m = jax.jit(f["ref"].loss)(f["params"],
                                              {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        total, m = f["port"].loss(batch)
    assert _rel(m["ce"], ref_m["ce"]) <= LOSS_RTOL and _rel(total, ref_total) <= LOSS_RTOL
    assert int(m["tokens"]) == int(ref_m["tokens"]) == int((batch["labels"] >= 0).sum())


def test_loss_ce_equals_full_logits_ce():
    """The chunked CE against one computed from forward's (B, S, V) logits."""
    f = _family("gemma2-2b")
    batch = f["batch"]
    with torch.no_grad():
        _, m = f["port"].loss(batch)
        logits, _ = f["port"].forward(batch)
    lab = torch.as_tensor(batch["labels"]).long()
    valid = lab >= 0
    nll = torch.nn.functional.cross_entropy(logits.transpose(1, 2), lab.clamp_min(0),
                                            reduction="none")
    assert _rel(m["ce"], nll[valid].mean()) <= LOSS_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_reference(arch):
    f = _family(arch)
    port = carry.params_to_reference(f["port"], f["grads"])
    _hold(port, f["ref_grads"], GRAD_BAND, f"{arch} grad")
    assert all(np.isfinite(a).all() for _, a in _leaves(port))


# ----------------------------------------------------------------------
# train steps from one carried TrainState
# ----------------------------------------------------------------------
def _states(arch):
    """(reference model, its TrainState, the port's model and TrainState
    carried from it)."""
    f = _family(arch)
    # init_train_state(ref, PRNGKey(0)), from the params _family drew with that key
    ref_state = RefTrainState(params=f["params"], opt=ref_adamw_init(f["params"]))
    model, state = carry.train_state_from_reference(
        f["cfg"], jax.tree.map(np.asarray, ref_state), device="cpu")
    return f, ref_state, model, state


def _steps(arch, n, batches):
    f, ref_state, model, state = _states(arch)
    ref_step = jax.jit(ref_make_train_step(f["ref"], RefAdamWConfig(lr=LR),
                                           schedule=ref_schedule.constant))
    step = make_train_step(model, AdamWConfig(lr=LR), schedule=schedule.constant)
    ref_losses, losses = [], []
    for i in range(n):
        ref_state, rm = ref_step(ref_state, {k: jnp.asarray(v) for k, v in batches[i].items()})
        state, m = step(state, batches[i])
        ref_losses.append(float(rm["loss"]))
        losses.append(float(m["loss"]))
    return f, jax.tree.map(np.asarray, ref_state), carry.train_state_to_reference(model, state), \
        ref_losses, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference(arch):
    """The port's step against the body of the reference's
    ``make_train_step`` at grad_accum 1: its ``adamw_update`` on its
    ``value_and_grad`` grads (already jitted for the grads test), at
    ``schedule.constant``'s scale.  ``test_three_steps_qwen3`` runs
    ``jax.jit(make_train_step)`` itself."""
    f, ref_state, model, state = _states(arch)
    params, opt, _ = ref_adamw_update(ref_state.params, f["ref_g"], ref_state.opt,
                                      RefAdamWConfig(lr=LR), ref_schedule.constant(0))
    ref_state = jax.tree.map(np.asarray, RefTrainState(params=params, opt=opt))
    state, m = make_train_step(model, AdamWConfig(lr=LR), schedule=schedule.constant)(
        state, f["batch"])
    state = carry.train_state_to_reference(model, state)
    assert _rel(m["loss"], f["ref_total"]) <= LOSS_RTOL
    assert int(state.opt.step) == int(ref_state.opt.step) == 1
    # after one step m = 0.1 x the clipped grad and v = 0.05 x its square
    _hold(state.opt.m, ref_state.opt.m, GRAD_BAND, f"{arch} m")
    _hold(state.opt.v, ref_state.opt.v, 2 * GRAD_BAND, f"{arch} v")
    # A first Adam step moves each param by ~lr * sign(g): a grad within
    # rounding of zero can take either sign in the two packages, and its
    # param then differs by up to 2 * lr.  So params are held to 2 * lr.
    _hold_abs(state.params, ref_state.params, 2 * LR * (1 + 1e-3), f"{arch} params")


def _hold_abs(port_tree, ref_tree, atol, what):
    port, ref = dict(_leaves(port_tree)), dict(_leaves(ref_tree))
    assert set(port) == set(ref)
    for k, r in ref.items():
        assert float(np.abs(port[k] - r).max()) <= atol, (what, k)


def test_three_steps_qwen3():
    f = _family("qwen3-14b")
    batches = [_batch(f["cfg"], 10 + i) for i in range(3)]
    _, _, _, ref_losses, losses = _steps("qwen3-14b", 3, batches)
    for a, b in zip(losses, ref_losses):
        assert _rel(a, b) <= 1e-4, (losses, ref_losses)


# ----------------------------------------------------------------------
# the reference's own training tests, on the port's own state
# ----------------------------------------------------------------------
def test_train_loss_decreases():
    cfg = get_config("gemma2-2b").reduced()
    model = Model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig(lr=3e-3))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    first = last = None
    for i in range(15):
        state, m = step(state, pipe.batch_at(i % 3))
        first = float(m["loss"]) if first is None else first
        last = float(m["loss"])
    assert last < first, f"loss did not decrease: {first} -> {last}"


def test_grad_accum_matches_full_batch():
    cfg = get_config("qwen3-14b").reduced()
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    batch = pipe.batch_at(0)
    out = []
    for accum in (1, 2):
        model = Model(cfg, device="cpu")
        state = init_train_state(model, torch.Generator().manual_seed(0))
        state, m = make_train_step(model, AdamWConfig(lr=1e-3), grad_accum=accum)(state, batch)
        assert sorted(m) == ["aux", "ce", "grad_norm", "loss", "lr_scale", "tokens"]
        out.append(state.params)
    # same data, same update (up to bf16 accumulation noise)
    assert max(float((out[0][k] - out[1][k]).detach().abs().max()) for k in out[0]) < 5e-3


def test_grad_accum_fp32_equals_one_batch():
    """fp32, labels all valid (so each microbatch's mean weighs alike): the
    summed microbatch grads equal the whole batch's, and so the moments."""
    f = _family("qwen3-14b")
    batch = _batch(f["cfg"], 5, b=4, s=32)
    batch["labels"] = np.abs(batch["labels"])
    ms = []
    for accum in (1, 2):
        _, _, model, state = _states("qwen3-14b")
        state, m = make_train_step(model, AdamWConfig(lr=LR), grad_accum=accum)(state, batch)
        ms.append((m, carry.params_to_reference(model, state.opt.m)))
    assert _rel(ms[1][0]["loss"], ms[0][0]["loss"]) <= LOSS_RTOL
    assert int(ms[1][0]["tokens"]) == int(ms[0][0]["tokens"]) == 128
    _hold(ms[1][1], ms[0][1], GRAD_BAND, "accumulated m")


# ----------------------------------------------------------------------
# training beside serving
# ----------------------------------------------------------------------
def test_serving_model_stores_cfg_dtype_and_training_fp32():
    cfg = get_config("hymba-1.5b").reduced()
    model = Model(cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16 and not model.embed.requires_grad
    assert model.layers[0].mamba["a_log"].dtype == torch.float32
    init_train_state(model, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())


def test_serving_after_a_train_step():
    """A trained model serves under no_grad (no graph is recorded), and its
    tokens equal those of a serving model carried from the same numbers."""
    f = _family("gemma2-2b")
    _, _, model, state = _states("gemma2-2b")
    state, _ = make_train_step(model, AdamWConfig(lr=LR), schedule=schedule.constant)(
        state, f["batch"])
    prompts = _batch(f["cfg"], 7, b=3, s=40)["tokens"]
    logits, cache = model.prefill({"tokens": prompts}, 48)
    assert not logits.requires_grad and not cache["k"].requires_grad
    logits, _ = model.decode_step(cache, logits.argmax(-1), torch.full((3,), 40))
    assert not logits.requires_grad
    served = carry.model_params_from_reference(
        f["cfg"], carry.params_to_reference(model), device="cpu")
    tokens = [ServeEngine(m, batch_slots=3, max_len=48).run(
        [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
        for m in (model, served)]
    assert tokens[0] == tokens[1] and all(len(t) == 6 for t in tokens[0].values())


def test_moe_drop_log_counts_each_forward_once():
    """Under training the layers are recomputed for the backward pass; the
    drop log still gets one entry per MoE layer and forward."""
    f = _family("olmoe-1b-7b")
    layers.moe_drop_log = []
    try:
        total, _ = f["port"].loss(f["batch"])
        torch.autograd.grad(total, list(f["port"].parameters()))
        assert len(layers.moe_drop_log) == f["cfg"].n_layers
    finally:
        layers.moe_drop_log = None


def test_mamba_scan_under_autograd_equals_no_grad():
    f = _family("hymba-1.5b")
    lp = f["port"].layers[0].mamba
    x = torch.as_tensor(np.random.default_rng(0).normal(0, 1, (2, 300, f["cfg"].d_model)),
                        dtype=torch.float32)
    with torch.no_grad():
        y0, st0 = ssm.mamba_seq(lp, x, f["cfg"])
    y1, st1 = ssm.mamba_seq(lp, x, f["cfg"])
    assert y1.requires_grad
    assert torch.equal(y0, y1.detach()) and torch.equal(st0["h"], st1["h"].detach())
