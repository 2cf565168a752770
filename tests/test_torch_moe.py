"""The port's MoE feed-forward and MoE models against the JAX package's.

``models.layers.moe_ffn`` gets the reference's ``moe_init`` weights (numpy)
and the same seeded activations, including a padded ragged batch, at the
reduced configs' capacity factor 8 (nothing drops) and at 0.05 (tokens
drop): outputs and the Switch aux loss are compared.  olmoe-1b-7b reduced
and llama4-scout reduced (its shared expert) run ``forward``, a ragged
``prefill`` and decode steps with the reference's weights carried, and
``ServeEngine`` generates the reference's tokens.  fp32 throughout,
rtol = atol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models.layers import moe_ffn as ref_moe_ffn
from repro.models.layers import moe_init as ref_moe_init
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.layers import moe_ffn
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]


def _cfgs(name, **overrides):
    ref_cfg = dataclasses.replace(ref_get_config(name).reduced(), dtype="float32", **overrides)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32", **overrides)
    return ref_cfg, cfg


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.as_tensor(np.array(v))
            for k, v in tree.items()}


def _padded_batch(d, seed, s=40, lens=(40, 23, 9), pad=None):
    """(B, S, D) activations; rows shorter than S end in copies of one pad
    vector, as a pad token's embedding would."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (len(lens), s, d)).astype(np.float32)
    pad = rng.normal(0, 1, d).astype(np.float32) if pad is None else pad
    for b, n in enumerate(lens):
        x[b, n:] = pad
    return x


@pytest.mark.parametrize("capacity_factor", [8.0, 0.05], ids=["cf8", "cf0.05"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_equals_reference(name, capacity_factor):
    ref_cfg, cfg = _cfgs(name, capacity_factor=capacity_factor)
    params = jax.tree.map(np.asarray, ref_moe_init(jax.random.PRNGKey(1), ref_cfg))
    x = _padded_batch(cfg.d_model, 2)
    r_out, r_aux = ref_moe_ffn(params, jnp.asarray(x), ref_cfg)
    p_out, p_aux = moe_ffn(_torch_tree(params), torch.as_tensor(x), cfg)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(float(p_aux), float(r_aux), **TOL)
    if capacity_factor < 1:
        # capacity 1 of 8 experts over 40 x 2 assignments: most tokens drop
        assert int(max(1, capacity_factor * 40 * cfg.top_k_experts / cfg.n_experts)) == 1


@pytest.mark.parametrize("capacity_factor", [8.0, 0.05], ids=["cf8", "cf0.05"])
def test_moe_pad_tail_takes_no_capacity_from_real_tokens(capacity_factor):
    """The stable sort keeps each expert's assignments in position order, so
    a row's pad tail overflows after its real tokens: what the pads hold does
    not change the real tokens' output."""
    _, cfg = _cfgs("olmoe-1b-7b", capacity_factor=capacity_factor)
    params = _torch_tree(jax.tree.map(np.asarray, ref_moe_init(jax.random.PRNGKey(1),
                                                                _cfgs("olmoe-1b-7b")[0])))
    lens = (40, 23, 9)
    a = _padded_batch(cfg.d_model, 3, lens=lens)
    b = _padded_batch(cfg.d_model, 3, lens=lens, pad=np.full(cfg.d_model, 3.0, np.float32))
    out_a, _ = moe_ffn(params, torch.as_tensor(a), cfg)
    out_b, _ = moe_ffn(params, torch.as_tensor(b), cfg)
    for r, n in enumerate(lens):
        assert torch.equal(out_a[r, :n], out_b[r, :n])


@pytest.mark.parametrize("capacity_factor", [8.0, 0.05], ids=["cf8", "cf0.05"])
def test_moe_drop_log_counts_overflow(capacity_factor):
    """``layers.moe_drop_log`` (off by default) gets each call's dropped
    (token, expert) assignments: per row and expert, the assignments past
    the capacity, counted from the reference's own top-k."""
    from repro_torch.models import layers

    ref_cfg, cfg = _cfgs("olmoe-1b-7b", capacity_factor=capacity_factor)
    params = jax.tree.map(np.asarray, ref_moe_init(jax.random.PRNGKey(1), ref_cfg))
    x = _padded_batch(cfg.d_model, 5)
    probs = jax.nn.softmax(jnp.asarray(x) @ params["router"], axis=-1)
    topi = np.asarray(jax.lax.top_k(probs, cfg.top_k_experts)[1])
    cap = int(max(1, capacity_factor * x.shape[1] * cfg.top_k_experts / cfg.n_experts))
    want = sum(int(np.maximum(np.bincount(row.ravel(), minlength=cfg.n_experts) - cap, 0).sum())
               for row in topi)
    assert layers.moe_drop_log is None
    layers.moe_drop_log = []
    try:
        moe_ffn(_torch_tree(params), torch.as_tensor(x), cfg)
        log = list(layers.moe_drop_log)
    finally:
        layers.moe_drop_log = None
    assert len(log) == 1 and int(log[0]) == want
    assert (want > 0) == (capacity_factor < 1)


def test_moe_ties_take_the_lowest_expert():
    """Equal router probabilities go to the lowest expert ids
    (``jax.lax.top_k``'s rule): a zero router sends every token to experts
    0..k-1 in both packages."""
    ref_cfg, cfg = _cfgs("olmoe-1b-7b")
    params = jax.tree.map(np.asarray, ref_moe_init(jax.random.PRNGKey(1), ref_cfg))
    params["router"] = np.zeros_like(params["router"])
    x = _padded_batch(cfg.d_model, 4)
    r_out, _ = ref_moe_ffn(params, jnp.asarray(x), ref_cfg)
    p_out, _ = moe_ffn(_torch_tree(params), torch.as_tensor(x), cfg)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), **TOL)


# ---------------------------------------------------------------------------
# the MoE models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def moe_model(request):
    ref_cfg, cfg = _cfgs(request.param)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = carry.model_params_from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, ref, params, port


def test_config_copies_match_reference():
    for name in ARCHS:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(ref_get_config(name))
        assert get_config(name).n_params() == ref_get_config(name).n_params()


def test_moe_parameters_carried(moe_model):
    cfg, _, params, port = moe_model
    own = port.state_dict()
    assert own["layers.1.ffn.w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    np.testing.assert_array_equal(own["layers.1.ffn.router"].numpy(),
                                  np.asarray(params["layers"]["ffn"]["router"][1]))
    shared = [n for n in own if ".ffn.shared." in n]
    if cfg.moe_shared_expert:
        assert len(shared) == 3 * cfg.n_layers
        np.testing.assert_array_equal(own["layers.0.ffn.shared.w_up"].numpy(),
                                      np.asarray(params["layers"]["ffn"]["shared"]["w_up"][0]))
    else:
        assert not shared


def test_moe_forward_and_aux_equal_reference(moe_model):
    cfg, ref, params, port = moe_model
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    r, r_aux = ref.forward(params, {"tokens": jnp.asarray(toks)})
    p, p_aux = port.forward({"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    assert float(p_aux) > 0
    np.testing.assert_allclose(float(p_aux), float(r_aux), **TOL)


def test_moe_prefill_and_decode_equal_reference(moe_model):
    cfg, ref, params, port = moe_model
    lens = np.array([5, 17, 12], np.int32)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (3, 17)).astype(np.int32)
    r_logits, r_cache = ref.prefill(params, {"tokens": jnp.asarray(toks)}, 32,
                                    lengths=jnp.asarray(lens))
    p_logits, p_cache = port.prefill({"tokens": torch.as_tensor(toks)}, 32,
                                     lengths=torch.as_tensor(lens))
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
    lengths = lens.copy()
    nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    for step in range(4):
        r_logits, r_cache = ref.decode_step(params, r_cache, jnp.asarray(nxt),
                                            jnp.asarray(lengths))
        p_logits, p_cache = port.decode_step(p_cache, torch.as_tensor(nxt),
                                             torch.as_tensor(lengths))
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL,
                                   err_msg=f"decode step {step}")
        lengths = lengths + 1
        nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)


def test_moe_serve_engine_equals_reference(moe_model):
    """Ragged prompts through both ServeEngines: the same tokens.  At the
    reduced capacity factor 8 nothing drops, so each row also decodes alone
    as in the batch."""
    cfg, ref, params, port = moe_model
    assert port.supports_ragged_prefill
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (3, 14, 8)]
    port_out = ServeEngine(port, batch_slots=3, max_len=32).run(
        [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    ref_out = RefServeEngine(ref, params, batch_slots=3, max_len=32).run(
        [RefRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    assert port_out == ref_out
    for i, p in enumerate(prompts):
        solo = ServeEngine(port, batch_slots=1, max_len=32).run(
            [Request(uid=0, prompt=p, max_new_tokens=5)])[0]
        assert solo == port_out[i], f"prompt {i} forked alone"


def test_moe_init_draws_reference_scales():
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    sd = a.state_dict()
    for (name, pa), pb in zip(sd.items(), b.state_dict().values()):
        assert pa.dtype == torch.bfloat16 and torch.equal(pa, pb), name
    d, f = cfg.d_model, cfg.d_ff
    for name, scale in (("layers.0.ffn.router", d ** -0.5), ("layers.0.ffn.w_gate", d ** -0.5),
                        ("layers.1.ffn.w_down", f ** -0.5),
                        ("layers.1.ffn.shared.w_down", f ** -0.5)):
        assert abs(float(sd[name].float().std()) / scale - 1.0) < 0.1, name
