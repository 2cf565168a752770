"""The port's dense LM against the JAX package's, on the CPU.

Both packages run ``qwen3-14b.reduced()`` in fp32.  The reference draws
its weights with ``Model.init(jax.random.PRNGKey(0))``; they go to numpy
and into the port through ``carry.model_params_from_reference``.  Compared:
``forward`` logits, ``prefill`` logits with ragged lengths and the cache
within each row's length, and four successive ``decode_step`` logits (the
port's decode attention runs its kernel's plain version here).  Tolerance
rtol = atol = 1e-4: fp32 throughout, only the order of sums differs.

Configurations the slice does not serve raise ``NotImplementedError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro_torch import carry
from repro_torch.configs import ModelConfig, get_config
from repro_torch.models import Model

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(**overrides):
    ref_cfg = dataclasses.replace(ref_get_config("qwen3-14b").reduced(), dtype="float32",
                                  **overrides)
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(), dtype="float32", **overrides)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = carry.model_params_from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, ref, params, port


@pytest.fixture(scope="module")
def models():
    return _pair()


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_config_copy_matches_reference():
    assert dataclasses.asdict(get_config("qwen3-14b")) == \
        dataclasses.asdict(ref_get_config("qwen3-14b"))
    assert get_config("qwen3-14b").n_params() == ref_get_config("qwen3-14b").n_params()


def test_parameters_carried_with_reference_names(models):
    cfg, _, params, port = models
    own = port.state_dict()
    assert len(own) == 3 + cfg.n_layers * 11
    np.testing.assert_array_equal(own["layers.1.attn.wq"].numpy(),
                                  np.asarray(params["layers"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(own["layers.0.ffn.w_down"].numpy(),
                                  np.asarray(params["layers"]["ffn"]["w_down"][0]))


def test_forward_logits_match(models):
    cfg, ref, params, port = models
    toks = _tokens(cfg, 0, (2, 12))
    r, _ = ref.forward(params, {"tokens": jnp.asarray(toks)})
    p, aux = port.forward({"tokens": torch.as_tensor(toks)})
    assert p.dtype == torch.float32 and aux == 0.0
    np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)


def test_prefill_and_decode_match(models):
    cfg, ref, params, port = models
    max_len, lens = 24, np.array([3, 10, 6], np.int32)
    toks = _tokens(cfg, 1, (3, 10))
    r_logits, r_cache = ref.prefill(params, {"tokens": jnp.asarray(toks)}, max_len,
                                    lengths=jnp.asarray(lens))
    p_logits, p_cache = port.prefill({"tokens": torch.as_tensor(toks)}, max_len,
                                     lengths=torch.as_tensor(lens))
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
    for name in ("k", "v"):
        assert p_cache[name].shape == r_cache[name].shape
        for b, n in enumerate(lens):
            np.testing.assert_allclose(p_cache[name][:, b, :, :n].numpy(),
                                       np.asarray(r_cache[name])[:, b, :, :n], **TOL)
    lengths = lens.copy()
    nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    for step in range(4):
        r_logits, r_cache = ref.decode_step(params, r_cache, jnp.asarray(nxt),
                                            jnp.asarray(lengths))
        p_logits, p_cache2 = port.decode_step(p_cache, torch.as_tensor(nxt),
                                              torch.as_tensor(lengths))
        assert p_cache2 is p_cache                  # written in place
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL,
                                   err_msg=f"decode step {step}")
        for b, n in enumerate(lengths + 1):
            np.testing.assert_allclose(p_cache["k"][:, b, :, :n].numpy(),
                                       np.asarray(r_cache["k"])[:, b, :, :n], **TOL)
        lengths = lengths + 1
        nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)


def test_dense_options_match_reference():
    """Post-norms, embedding scale, final softcap and tied embeddings: dense
    options the port serves although qwen3 does not use them."""
    cfg, ref, params, port = _pair(post_norms=True, embed_scale=True, final_softcap=30.0,
                                   tie_embeddings=True)
    assert "lm_head" not in port.state_dict()
    toks = _tokens(cfg, 2, (2, 9))
    r, _ = ref.forward(params, {"tokens": jnp.asarray(toks)})
    p, _ = port.forward({"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    r_logits, r_cache = ref.prefill(params, {"tokens": jnp.asarray(toks)}, 16)
    p_logits, p_cache = port.prefill({"tokens": torch.as_tensor(toks)}, 16)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
    nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    lengths = np.full(2, 9, np.int32)
    r_logits, _ = ref.decode_step(params, r_cache, jnp.asarray(nxt), jnp.asarray(lengths))
    p_logits, _ = port.decode_step(p_cache, torch.as_tensor(nxt), torch.as_tensor(lengths))
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)


def test_init_draws_reference_scales():
    """Random init from a torch.Generator: reference shapes, scales, zero
    norms, stored in cfg.dtype; the same seed gives the same weights."""
    cfg = get_config("qwen3-14b").reduced()
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert pa.dtype == torch.bfloat16 and torch.equal(pa, pb), name
    sd = a.state_dict()
    assert float(sd["layers.0.ln1"].abs().max()) == 0.0
    assert float(sd["layers.1.attn.q_norm"].abs().max()) == 0.0
    d, f = cfg.d_model, cfg.d_ff
    for name, scale in (("embed", d ** -0.5), ("layers.0.attn.wo", (cfg.n_heads * cfg.dh) ** -0.5),
                        ("layers.1.ffn.w_down", f ** -0.5)):
        assert abs(float(sd[name].float().std()) / scale - 1.0) < 0.1, name


def _port_cfg(ref_cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(ref_cfg))


@pytest.mark.parametrize("name", sorted(n for n, c in REF_REGISTRY.items()
                                        if c.family != "dense" or c.is_moe))
def test_other_families_are_refused(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(_port_cfg(REF_REGISTRY[name].reduced()), device="cpu")


@pytest.mark.parametrize("change", [
    dict(attn_softcap=50.0),
    dict(sliding_window=64, layer_pattern="local_global"),
    dict(sliding_window=64),
    dict(kv_cache_int8=True),
    dict(n_experts=4, top_k_experts=2),
])
def test_unported_features_are_refused(change):
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(), **change)
    with pytest.raises(NotImplementedError):
        Model(cfg, device="cpu")
    assert ref_get_config("gemma2-2b").attn_softcap > 0      # what waits for the window port


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_config("qwen3-14b").reduced())
