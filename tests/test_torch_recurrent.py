"""The port's recurrent families (hymba-1.5b, xlstm-1.3b) against the JAX
package's, on the CPU.

Both packages run ``reduced()`` configurations (xlstm at 4 layers, two
groups of one sLSTM and one mLSTM; hymba at 2 layers, layer 0 global and
layer 1 with a 64-token window that 70-token prompts pass).  The
reference draws its weights with ``Model.init(jax.random.PRNGKey(0))``;
they go to numpy and into the port through
``carry.model_params_from_reference``.  The reference runs under
``jax.jit``, as its ``ServeEngine`` runs it.  Compared: ``forward`` logits,
``prefill`` logits and every cache leaf (K/V within the prompt, the Mamba,
sLSTM and mLSTM states), then four ``decode_step``s' logits and leaves.

Tolerances: fp32 at rtol = atol = 1e-4, as ``test_torch_models.py`` (only
the order of sums differs).  bf16: |port - reference| <= 5e-2 x max|reference|
of each compared tensor.  The two packages round bf16 products, sums and
elementwise results (8 significant bits, 2**-8 ~ 0.4 % a rounding) at
other places (XLA on the CPU fuses elementwise work in fp32), and these
compound over the layers and the recurrences: up to ~2 % of the tensor's
largest magnitude here (0.105 on logits of max 4.28).  ``ServeEngine``
serves the reference's tokens on equal-length prompts and refuses unequal
ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.models import Model, ssm
from repro_torch.serve import Request, ServeEngine

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LAYERS = {"hymba-1.5b": 2, "xlstm-1.3b": 4}
PROMPT = 70


_MODELS = {}
_PARAMS = {}


def _models(arch, dtype):
    """(port cfg, reference Model, reference params, port Model), made once
    per (arch, dtype); both dtypes share the reference's fp32 masters."""
    if (arch, dtype) not in _MODELS:
        ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype=dtype,
                                      n_layers=LAYERS[arch])
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                                  n_layers=LAYERS[arch])
        ref = RefModel(ref_cfg)
        if arch not in _PARAMS:
            _PARAMS[arch] = jax.jit(ref.init)(jax.random.PRNGKey(0))
        params = _PARAMS[arch]
        port = carry.model_params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                                 device="cpu")
        _MODELS[(arch, dtype)] = (cfg, ref, params, port)
    return _MODELS[(arch, dtype)]


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _leaves(cache, prefix=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(port, ref, tol, what):
    """fp32 (tol 1e-4): rtol = atol = tol; bf16 (tol 5e-2): atol = tol x
    max|ref|, the band of the module's docstring."""
    port, ref = _np(port), _np(ref)
    atol = tol * float(np.abs(ref).max()) if tol > 1e-4 else tol
    np.testing.assert_allclose(port, ref, rtol=tol if tol <= 1e-4 else 0, atol=atol,
                               err_msg=what)


def _cache_close(p_cache, r_cache, n, tol, what):
    p_leaves, r_leaves = dict(_leaves(p_cache)), dict(_leaves(r_cache))
    assert set(p_leaves) == set(r_leaves), what
    for name, r in r_leaves.items():
        p = p_leaves[name]
        assert tuple(p.shape) == tuple(np.shape(r)), name
        if name in ("k", "v"):            # (L, B, KV, S, dh): the positions written
            p, r = p[:, :, :, :n], np.asarray(r)[:, :, :, :n]
        _close(p, r, tol, f"{what}: {name}")


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_config_copy_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    assert get_config(arch).n_params() == ref_get_config(arch).n_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_forward_prefill_decode_match(arch, dtype):
    cfg, ref, params, port = _models(arch, dtype)
    tol = TOL[dtype]
    toks = _tokens(cfg, 0, (2, PROMPT))
    r, _ = jax.jit(ref.forward)(params, {"tokens": jnp.asarray(toks)})
    p, aux = port.forward({"tokens": torch.as_tensor(toks)})
    assert p.dtype == torch.float32 and aux == 0.0
    _close(p, r, tol, "forward")

    max_len = PROMPT + 8
    lens = np.full(2, PROMPT, np.int32)
    r_logits, r_cache = jax.jit(lambda p, b, n: ref.prefill(p, b, max_len, lengths=n))(
        params, {"tokens": jnp.asarray(toks)}, jnp.asarray(lens))
    p_logits, p_cache = port.prefill({"tokens": torch.as_tensor(toks)}, max_len,
                                     lengths=torch.as_tensor(lens))
    _close(p_logits, r_logits, tol, "prefill")
    _cache_close(p_cache, r_cache, PROMPT, tol, "prefill")
    lengths = lens.copy()
    nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    ref_decode = jax.jit(ref.decode_step)
    for step in range(4):
        r_logits, r_cache = ref_decode(params, r_cache, jnp.asarray(nxt), jnp.asarray(lengths))
        p_logits, p_cache2 = port.decode_step(p_cache, torch.as_tensor(nxt),
                                              torch.as_tensor(lengths))
        assert p_cache2 is p_cache                  # updated in place
        lengths = lengths + 1
        _close(p_logits, r_logits, tol, f"decode step {step}")
        _cache_close(p_cache, r_cache, int(lengths[0]), tol, f"decode step {step}")
        nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_serve_engine_tokens_equal_reference(arch):
    cfg, ref, params, port = _models(arch, "float32")
    prompts = [_tokens(cfg, 10 + i, PROMPT) for i in range(3)]
    port_out = ServeEngine(port, batch_slots=3, max_len=PROMPT + 8).run(
        [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    ref_out = RefServeEngine(ref, params, batch_slots=3, max_len=PROMPT + 8).run(
        [RefRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    assert port_out == {k: [int(t) for t in v] for k, v in ref_out.items()}


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_unequal_prompt_lengths_raise(arch):
    cfg, _, _, port = _models(arch, "float32")
    assert not port.supports_ragged_prefill
    with pytest.raises(ValueError, match="equal-length"):
        ServeEngine(port, batch_slots=2, max_len=32).run(
            [Request(uid=0, prompt=_tokens(cfg, 1, 9)), Request(uid=1, prompt=_tokens(cfg, 2, 12))])


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_uncast_weights_stay_fp32_in_bf16(arch):
    """The weights the reference uses uncast keep fp32 in a bf16 model, from
    ``carry`` and from ``init``; every other weight is bf16.  ``init`` sets
    Mamba's a_log, d_skip and dt_bias to the reference's values."""
    cfg, _, params, port = _models(arch, "bfloat16")
    fresh = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    fp32 = ssm.MAMBA_FP32 if arch.startswith("hymba") else ssm.SLSTM_FP32
    for model in (port, fresh):
        for name, p in model.state_dict().items():
            want = torch.float32 if name.split(".")[-1] in fp32 and (
                ".mamba." in name or ".slstm." in name) else torch.bfloat16
            assert p.dtype == want, name
    if arch.startswith("hymba"):
        sd = fresh.state_dict()
        for name, val in ssm.mamba_constants(cfg).items():
            for i in range(cfg.n_layers):
                assert torch.equal(sd[f"layers.{i}.mamba.{name}"], val), name
        np.testing.assert_allclose(port.state_dict()["layers.1.mamba.a_log"].numpy(),
                                   np.asarray(params["layers"]["mamba"]["a_log"][1]))
