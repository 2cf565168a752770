"""The port's serving over a model axis larger than 1, on the CPU.

A model cut by ``dist.tensor_parallel.shard_model`` over the model axis of
a (1, 2) or (1, 4) gloo mesh (one spawned process a rank, over
``tcp://localhost``) serves through ``Model.prefill``, ``Model.decode_step``
and ``ServeEngine.run``, held to the same whole model in one process.  The
weights come from ``Model.init`` under one seed in every process (reduced
configs, fp32); the reference's side gets them through
``carry.params_to_reference``.  Eight configs: qwen3-14b (dense),
gemma2-2b (windows, softcaps), gemma2-2b with the int8 KV cache,
olmoe-1b-7b (experts split), hymba-1.5b (attention split at (1, 2) and
gathered at (1, 4), Mamba gathered), xlstm-1.3b (every recurrence
gathered), seamless-m4t-large-v2 (the cross cache) and internvl2-76b (the
patch prefix).  The reduced configs have 2 KV heads (olmoe, xlstm and
seamless 4): at (1, 4) most attentions run gathered.

Per config and mesh, on every rank: a prefill of 3 prompts (ragged but for
the recurrent families) and 8 greedy decode steps.  Against the one-process
run: every step's logits within 1e-5 x the step's max |logit|, the greedy
tokens equal, and every leaf of the final cache within 1e-6 x max(1, the
leaf's max |value|) (the cache is whole and replicated on every rank: each
rank holds all heads).  ``ServeEngine.run`` over 3 requests in 2 slots gives
the one-process tokens (frontend models excepted: the engine serves token
prompts only, as the reference's).  At (1, 2) rank 0's logits are held to
the reference's jitted ``prefill`` and ``decode_step`` on the same weights
and tokens within rtol = atol = 1e-4, ``test_torch_models``' band.

The split sums round in another order than the whole products: fp32
throughout, and the bands above are far above what was observed.  Each
world size runs its cases in one spawn (``test_torch_tp_train.spawn``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.dist.tensor_parallel import shard_model, split_units
from repro_torch.models import Model
from repro_torch.serve import Request, ServeEngine
from test_torch_tp_train import spawn

CASES = {"qwen3-14b": ("qwen3-14b", {}), "gemma2-2b": ("gemma2-2b", {}),
         "gemma2-2b-int8": ("gemma2-2b", {"kv_cache_int8": True}),
         "olmoe-1b-7b": ("olmoe-1b-7b", {}), "hymba-1.5b": ("hymba-1.5b", {}),
         "xlstm-1.3b": ("xlstm-1.3b", {}), "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
         "internvl2-76b": ("internvl2-76b", {})}
MESHES = ((1, 2), (1, 4))
BATCH, PROMPT, NEW, MAX_LEN = 3, 10, 8, 24
LOGIT_REL, CACHE_REL = 1e-5, 1e-6
_RUNS = {}


def cfg_of(case: str):
    arch, overrides = CASES[case]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **overrides)


def model_of(case: str) -> Model:
    """The whole model of ``case``: the same weights in every process."""
    return Model(cfg_of(case), device="cpu").init(torch.Generator().manual_seed(0))


def inputs(cfg):
    """(tokens (B, S), prompt lengths, the stub frames or patches or None):
    ragged prompts, equal ones for the recurrent families."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    plens = (np.full(BATCH, PROMPT, np.int32) if cfg.family in ("ssm", "hybrid")
             else np.array([PROMPT, PROMPT - 3, PROMPT - 6], np.int32))
    front = None
    if cfg.frontend != "none":
        front = rng.normal(0, 1, (BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return toks, plens, front


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def drive(model: Model) -> dict:
    """Prefill and NEW greedy decode steps, then ServeEngine: each step's
    logits, the greedy tokens, the final cache, the engine's tokens."""
    cfg = model.cfg
    toks, plens, front = inputs(cfg)
    batch = {"tokens": torch.as_tensor(toks)}
    n_prefix = 0
    if front is not None:
        batch["patches" if cfg.family == "vlm" else "frames"] = torch.as_tensor(front)
        n_prefix = cfg.frontend_len if cfg.family == "vlm" else 0
    logits, cache = model.prefill(batch, MAX_LEN + n_prefix, lengths=torch.as_tensor(plens))
    fill = torch.as_tensor(plens + n_prefix)
    steps, tokens = [logits.numpy().copy()], []
    for _ in range(NEW):
        nxt = torch.argmax(logits, -1).to(torch.int32)
        tokens.append(nxt.numpy().copy())
        logits, cache = model.decode_step(cache, nxt, fill)
        fill = fill + 1
        steps.append(logits.numpy().copy())
    out = {"logits": steps, "tokens": tokens, "cache": _numpy(cache)}
    if front is None:
        reqs = [Request(uid=i, prompt=toks[i, :plens[i]], max_new_tokens=NEW - i)
                for i in range(BATCH)]
        out["served"] = ServeEngine(model, batch_slots=2, max_len=MAX_LEN).run(reqs)
    return out


def serve_case(mesh, job: dict) -> dict:
    """One case on this rank: the whole model cut to this rank's blocks of
    the mesh's model axis, then driven."""
    model = model_of(job["case"])
    shard_model(model, mesh["model"].get_group())
    return drive(model)


def _runs(world: int) -> dict:
    if world not in _RUNS:
        mesh = next(m for m in MESHES if m[0] * m[1] == world)
        _RUNS[world] = spawn(world, {case: {"case": case, "mesh": mesh} for case in CASES},
                             case=serve_case)
    return _RUNS[world]


_ONE = {}


def one_process(case: str) -> dict:
    if case not in _ONE:
        _ONE[case] = drive(model_of(case))
    return _ONE[case]


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tp_serving_equals_one_process(mesh, case):
    want = one_process(case)
    runs = _runs(mesh[0] * mesh[1])
    for rank, res in runs.items():
        got = res[case]
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            gap = float(np.abs(g - w).max())
            assert gap <= LOGIT_REL * float(np.abs(w).max()), (rank, i, gap)
        for g, w in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w)
        got_c, want_c = dict(_leaves(got["cache"])), dict(_leaves(want["cache"]))
        assert set(got_c) == set(want_c)
        for k, w in want_c.items():
            assert got_c[k].shape == w.shape and got_c[k].dtype == w.dtype, (rank, k)
            if w.dtype == np.int8:       # int8 K/V: a rounding flip is one step of 127
                assert int(np.abs(got_c[k].astype(np.int32) - w).max()) <= 1, (rank, k)
                continue
            gap = float(np.abs(got_c[k] - w).max())
            assert gap <= CACHE_REL * max(1.0, float(np.abs(w).max())), (rank, k, gap)
        if "served" in want:
            assert got["served"] == want["served"], rank


def test_meshes_cover_split_and_gathered_attention():
    """The cases run attention both split and gathered over the model axis."""
    split = {(case, n): split_units(cfg_of(case), n)["attn"] for case in CASES for n in (2, 4)}
    assert split["gemma2-2b", 2] and not split["gemma2-2b", 4]
    assert split["hymba-1.5b", 2] and not split["hymba-1.5b", 4]
    assert split["olmoe-1b-7b", 4] and split_units(cfg_of("olmoe-1b-7b"), 4)["experts"]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_serving_equals_reference_1x2(case):
    """Rank 0 of the (1, 2) run against the reference's jitted prefill and
    decode_step on the same weights (carried to it), fed the same greedy
    tokens.  (The JAX package is imported here, not at the top: every
    spawned rank imports this module.)"""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import Model as RefModel

    got = _runs(2)[0][case]
    arch, overrides = CASES[case]
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32", **overrides)
    ref = RefModel(ref_cfg)
    params = jax.tree.map(jnp.asarray, carry.params_to_reference(model_of(case)))
    toks, plens, front = inputs(ref_cfg)
    batch = {"tokens": jnp.asarray(toks)}
    n_prefix = 0
    if front is not None:
        batch["patches" if ref_cfg.family == "vlm" else "frames"] = jnp.asarray(front)
        n_prefix = ref_cfg.frontend_len if ref_cfg.family == "vlm" else 0
    prefill = jax.jit(ref.prefill, static_argnums=2)
    decode = jax.jit(ref.decode_step)
    logits, cache = prefill(params, batch, MAX_LEN + n_prefix, lengths=jnp.asarray(plens))
    fill = jnp.asarray(plens + n_prefix)
    np.testing.assert_allclose(got["logits"][0], np.asarray(logits), rtol=1e-4, atol=1e-4)
    for i, nxt in enumerate(got["tokens"]):
        logits, cache = decode(params, cache, jnp.asarray(nxt), fill)
        fill = fill + 1
        np.testing.assert_allclose(got["logits"][i + 1], np.asarray(logits), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i}")
