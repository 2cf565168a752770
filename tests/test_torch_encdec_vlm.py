"""The port's encdec and vlm families against the JAX package's, on the CPU.

Both packages run ``seamless-m4t-large-v2.reduced()`` (encdec: 2 encoder
and 2 decoder layers over 16 stub frames) and ``internvl2-76b.reduced()``
(vlm: 16 stub patches before the prompt of a dense backbone) in fp32,
d_model 128.  The reference draws its weights with
``Model.init(jax.random.PRNGKey(0))``; they go into the port through
``carry.model_params_from_reference`` (and back, every leaf, none left
over).  Inputs come from a numpy seed.  Compared within rtol = atol = 1e-4
(fp32; only the order of sums differs): ``forward`` logits, ``loss``
(relative 1e-5), ``prefill`` logits and cache (the cross cache ``xk``/``xv``
included), three ``decode_step`` logits and caches (a vlm model's
``lengths`` count its prefix), a ragged vlm batch.  The port's decode
cross-attention runs the decode kernel's plain version here (on a card,
the kernel: ``chip_smoke.py`` phases 3f and 12); its identity with the
reference's non-causal ``flash_attention`` is held on its own, as is the
non-causal ``flash_attention``.  Grads and a train step of both families
are in ``test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro_torch import carry
from repro_torch.configs import REGISTRY, get_config
from repro_torch.kernels import decode_attention_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model, layers
from repro_torch.models import model as model_mod
from repro_torch.serve import ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
ARCHS = ("seamless-m4t-large-v2", "internvl2-76b")
_MODELS = {}


def _pair(arch):
    """(port cfg, reference model, its fp32 params, the port's model carrying
    them): made once per arch."""
    if arch not in _MODELS:
        ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        ref = RefModel(ref_cfg)
        params = jax.jit(ref.init)(jax.random.PRNGKey(0))
        port = carry.model_params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                                 device="cpu")
        _MODELS[arch] = (cfg, ref, params, port)
    return _MODELS[arch]


def _batch(cfg, seed, b, s, labels=False):
    """Tokens (and labels, some -1) and the stub frames or patches."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        lab[:, ::5] = -1
        batch["labels"] = lab
    batch["patches" if cfg.family == "vlm" else "frames"] = rng.normal(
        0, 1, (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    assert get_config(arch).n_params() == ref_get_config(arch).n_params()


def test_every_registry_family_constructs_at_full_size():
    """No family of the registry is refused; at full size (fake tensors:
    internvl2-76b would be 141 GB) each model has the reference's
    parameter count, encoder and cross-attention included."""
    assert set(REGISTRY) == set(REF_REGISTRY)
    for name, cfg in REGISTRY.items():
        ref = jax.eval_shape(RefModel(REF_REGISTRY[name]).init, jax.random.PRNGKey(0))
        with FakeTensorMode():
            n = sum(p.numel() for p in Model(cfg, device="cpu").parameters())
        assert n == sum(a.size for a in jax.tree.leaves(ref)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_carry_maps_every_leaf_both_ways(arch):
    cfg, _, params, port = _pair(arch)
    names = dict(port.named_parameters())
    if cfg.is_encdec:
        assert {"enc_final_ln", "enc_layers.1.attn.wq", "layers.1.ln_x",
                "layers.0.xattn.wk"} <= set(names)
        np.testing.assert_array_equal(names["enc_layers.1.ffn.w_up"].detach().numpy(),
                                      np.asarray(params["enc_layers"]["ffn"]["w_up"][1]))
    back, ref = _leaves(carry.params_to_reference(port)), _leaves(params)
    assert set(back) == set(ref)
    for k, a in ref.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match(arch):
    cfg, ref, params, port = _pair(arch)
    batch = _batch(cfg, 0, 2, 12, labels=True)
    r, _ = ref.forward(params, _jnp({k: v for k, v in batch.items() if k != "labels"}))
    p, aux = port.forward(batch)
    assert p.shape == (2, 12, cfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    r_total, r_m = ref.loss(params, _jnp(batch))
    with torch.no_grad():
        total, m = port.loss(batch)
    assert abs(float(total) - float(r_total)) <= LOSS_RTOL * abs(float(r_total))
    assert int(m["tokens"]) == int(r_m["tokens"])


def _prefill_decode(arch, lens, steps=3):
    """prefill at ragged ``lens`` and ``steps`` decode steps in both
    packages, the port's written in place; logits and caches compared at
    each step within each row's fill."""
    cfg, ref, params, port = _pair(arch)
    s = int(lens.max())
    batch = _batch(cfg, 1, len(lens), s)
    n_prefix = cfg.frontend_len if cfg.family == "vlm" else 0
    max_len = n_prefix + s + steps + 1
    r_logits, r_cache = ref.prefill(params, _jnp(batch), max_len, lengths=jnp.asarray(lens))
    p_logits, p_cache = port.prefill(batch, max_len, lengths=torch.as_tensor(lens))
    assert sorted(p_cache) == sorted(r_cache)
    assert all(tuple(p_cache[k].shape) == r_cache[k].shape for k in p_cache)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
    fill = lens + n_prefix                       # decode lengths count the prefix
    for name in ("xk", "xv") if cfg.is_encdec else ():
        np.testing.assert_allclose(p_cache[name].numpy(), np.asarray(r_cache[name]), **TOL)
    nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    for step in range(steps + 1):
        for name in ("k", "v"):
            for b, n in enumerate(fill):
                np.testing.assert_allclose(p_cache[name][:, b, :, :n].numpy(),
                                           np.asarray(r_cache[name])[:, b, :, :n], **TOL,
                                           err_msg=f"{name} after {step} steps")
        if step == steps:
            break
        r_logits, r_cache = ref.decode_step(params, r_cache, jnp.asarray(nxt),
                                            jnp.asarray(fill))
        p_logits, p_cache2 = port.decode_step(p_cache, torch.as_tensor(nxt),
                                              torch.as_tensor(fill))
        assert p_cache2 is p_cache
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL,
                                   err_msg=f"decode step {step}")
        fill = fill + 1
        nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    return port, batch, p_logits


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps_match(arch):
    _prefill_decode(arch, np.array([10, 10], np.int32))


def test_ragged_vlm_batch_gathers_past_the_prefix():
    """Ragged prompts: each row's logits at P + length - 1 (the
    reference's), and equal to the row prefilled alone."""
    port, batch, _ = _prefill_decode("internvl2-76b", np.array([4, 11, 7], np.int32), steps=1)
    lens = np.array([4, 11, 7], np.int32)
    logits, _ = port.prefill(batch, 40, lengths=torch.as_tensor(lens))
    for i, n in enumerate(lens):
        solo, _ = port.prefill({"tokens": batch["tokens"][i:i + 1, :n],
                                "patches": batch["patches"][i:i + 1]}, 40)
        np.testing.assert_allclose(logits[i].numpy(), solo[0].numpy(), **TOL)


def test_decode_step_runs_the_decode_kernel_twice_a_layer(monkeypatch):
    """An encdec decode step calls ``decode_attention`` once a layer for
    self-attention and once for cross-attention (at length F, every row);
    a vlm step once a layer, its lengths counting the prefix."""
    calls = []

    def counting(q, k, v, length, *args, **kw):
        calls.append((tuple(k.shape), length.tolist()))
        return decode_attention_ref(q, k, v, length, *args, **kw)

    monkeypatch.setattr(model_mod, "decode_attention", counting)
    for arch in ARCHS:
        cfg, _, _, port = _pair(arch)
        batch = _batch(cfg, 2, 2, 5)
        n_prefix = cfg.frontend_len if cfg.family == "vlm" else 0
        _, cache = port.prefill(batch, n_prefix + 8)
        calls.clear()
        port.decode_step(cache, torch.tensor([1, 2]), torch.tensor([n_prefix + 5] * 2))
        kv, dh, f = cfg.n_kv_heads, cfg.dh, cfg.frontend_len
        self_call = ((2, kv, n_prefix + 8, dh), [n_prefix + 6] * 2)
        cross = [((2, kv, f, dh), [f, f])] if cfg.is_encdec else []
        assert calls == [self_call, *cross] * cfg.n_layers, arch


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_non_causal_matches_reference(window):
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (2, 150, 2, 3, 32)).astype(np.float32)   # two query chunks
    k, v = (rng.normal(0, 1, (2, 40, 2, 32)).astype(np.float32) for _ in range(2))
    r = ref_layers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=False, window=window)
    p = layers.flash_attention(*map(torch.as_tensor, (q, k, v)), window, causal=False)
    np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    if window is None:      # every query sees every key: rows depend on nothing but q
        np.testing.assert_allclose(p[:, :1].numpy(), layers.flash_attention(
            *map(torch.as_tensor, (q[:, :1], k, v)), causal=False).numpy(), **TOL)


def test_decode_attention_is_cross_attention_at_full_length():
    """The decode kernel's contract at length F for every row, no window
    and softcap 0, equals the reference's cross-attention of one token
    (``flash_attention(q, xk, xv, causal=False)``), at seamless's GQ = 1."""
    rng = np.random.default_rng(4)
    b, f, kv, g, dh = 3, 24, 4, 1, 32
    q = rng.normal(0, 1, (b, 1, kv, g, dh)).astype(np.float32)
    xk, xv = (rng.normal(0, 1, (b, f, kv, dh)).astype(np.float32) for _ in range(2))
    r = ref_layers.flash_attention(jnp.asarray(q), jnp.asarray(xk), jnp.asarray(xv),
                                   causal=False, window=None)
    p = decode_attention_ref(torch.as_tensor(q[:, 0]),
                             torch.as_tensor(xk).transpose(1, 2).contiguous(),
                             torch.as_tensor(xv).transpose(1, 2).contiguous(),
                             torch.full((b,), f, dtype=torch.int32))
    np.testing.assert_allclose(p.numpy(), np.asarray(r)[:, 0], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_and_cli_refuse_frontend_models(arch):
    _, _, _, port = _pair(arch)
    with pytest.raises(NotImplementedError, match="Model.prefill"):
        ServeEngine(port, batch_slots=2, max_len=32)
    with pytest.raises(NotImplementedError, match="frontend"):
        serve_cli.main(["--mode", "lm", "--arch", arch, "--device", "cpu"])
