"""Sliding windows and the attention softcap in the port, against the JAX package.

The same seeded numpy inputs go through the reference's
``models.layers.decode_attention_xla`` / ``flash_attention`` and the port's
``kernels.ref.decode_attention_ref`` / ``kernels.ops.decode_attention`` (the
kernel's plain version on CPU tensors) / ``models.layers.flash_attention``;
then gemma2-2b reduced (fp32, the reference's weights carried) through
``forward``, a ragged ``prefill`` and decode steps past the window, with
the reduced window of 64 and again with 16, and ``ServeEngine`` tokens.
Tolerance rtol = atol = 1e-4 (fp32, only the order of sums differs).
The CUDA kernel's window and softcap are held to the plain version on the
card by ``chip_smoke.py`` (phase 3c) and emulated here by
``test_torch_decode_attention.py::test_kernel_decomposition_window_*``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models.layers import decode_attention_xla as ref_decode_attention_xla
from repro.models.layers import flash_attention as ref_flash_attention
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention, decode_attention_ref
from repro_torch.kernels.decode_attention import window_positions
from repro_torch.models.layers import flash_attention
from repro_torch.models.model import GLOBAL_WINDOW, _windows
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)


def _decode_inputs(seed, b, kv, gq, s, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, kv, gq, dh)).astype(np.float32)
    k = rng.normal(0, 1, (b, kv, s, dh)).astype(np.float32)
    v = rng.normal(0, 1, (b, kv, s, dh)).astype(np.float32)
    return q, k, v


# ---------------------------------------------------------------------------
# the decode contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("softcap", [0.0, 50.0, 2.0], ids=["nocap", "cap50", "cap2"])
@pytest.mark.parametrize("window", [None, 100, 37, 1, GLOBAL_WINDOW])
def test_decode_ref_equals_reference(window, softcap):
    """Windows that are no multiple of a chunk (37, 100: the chunk at S=700,
    dh=64 is 128 positions), lengths below and above the window, a window
    of one position, and GLOBAL_WINDOW (full attention)."""
    s, dh = 700, 64
    q, k, v = _decode_inputs(3, 6, 2, 4, s, dh)
    length = np.array([1, 20, 99, 101, 333, 700], np.int32)
    ref = ref_decode_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(length), window=window, attn_softcap=softcap)
    args = tuple(map(torch.as_tensor, (q, k, v, length)))
    plain = decode_attention_ref(*args, window=window, attn_softcap=softcap)
    through_ops = decode_attention(*args, window=window, attn_softcap=softcap)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(through_ops, plain)


def test_decode_window_reads_only_the_window():
    """NaN outside [len - window, len) never reaches the plain version's
    scores; a window of one position returns that position's value row."""
    q, k, v = _decode_inputs(4, 2, 2, 2, 300, 32)
    length = torch.tensor([150, 300], dtype=torch.int32)
    qt, kt, vt = map(torch.as_tensor, (q, k, v))
    out = decode_attention_ref(qt, kt, vt, length, window=1)
    for b, n in enumerate((150, 300)):
        np.testing.assert_allclose(out[b].numpy(),
                                   np.broadcast_to(v[b, :, n - 1][:, None], (2, 2, 32)), **TOL)
    kn = kt.clone()
    kn[0, :, :150 - 40] = float("nan")
    kn[0, :, 150:] = float("nan")
    assert torch.isfinite(decode_attention_ref(qt, kn, vt, length, window=40)[0]).all()


def test_window_positions_and_contract():
    assert window_positions(None, 700) == 700
    assert window_positions(GLOBAL_WINDOW, 700) == 700
    assert window_positions(100, 700) == 100
    q, k, v = _decode_inputs(5, 1, 2, 2, 64, 32)
    args = tuple(map(torch.as_tensor, (q, k, v, np.array([8], np.int32))))
    for bad in (dict(window=0), dict(window=2.5), dict(attn_softcap=-1.0),
                dict(attn_softcap=float("inf"))):
        with pytest.raises(ValueError):
            decode_attention(*args, **bad)


# ---------------------------------------------------------------------------
# the prefill attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,softcap", [(None, 50.0), (100, 0.0), (100, 50.0), (37, 5.0)])
def test_flash_attention_equals_reference(window, softcap):
    """Sq = 300 spans three 128-query chunks, so the window crosses a chunk
    boundary."""
    rng = np.random.default_rng(6)
    q = rng.normal(0, 1, (2, 300, 2, 2, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, 300, 2, 32)).astype(np.float32)
    v = rng.normal(0, 1, (2, 300, 2, 32)).astype(np.float32)
    ref = ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                              attn_softcap=softcap)
    port = flash_attention(*map(torch.as_tensor, (q, k, v)), window=window, attn_softcap=softcap)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# gemma2-2b reduced
# ---------------------------------------------------------------------------
def _gemma(window):
    ref_cfg = dataclasses.replace(ref_get_config("gemma2-2b").reduced(), dtype="float32",
                                  sliding_window=window)
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), dtype="float32",
                              sliding_window=window)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = carry.model_params_from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, ref, params, port


@pytest.fixture(scope="module", params=[64, 16], ids=["window64", "window16"])
def gemma(request):
    return _gemma(request.param)


def test_gemma2_config_copy_and_windows():
    assert dataclasses.asdict(get_config("gemma2-2b")) == \
        dataclasses.asdict(ref_get_config("gemma2-2b"))
    cfg = get_config("gemma2-2b")
    w = _windows(cfg, cfg.n_layers)
    assert w[0::2] == [4096] * 13 and w[1::2] == [GLOBAL_WINDOW] * 13
    qwen = dataclasses.replace(get_config("qwen3-14b"), sliding_window=64)
    assert _windows(qwen, 3) == [GLOBAL_WINDOW] * 3       # "global" ignores the window


def test_gemma2_forward_equals_reference(gemma):
    cfg, ref, params, port = gemma
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 150)).astype(np.int32)
    r, _ = ref.forward(params, {"tokens": jnp.asarray(toks)})
    p, aux = port.forward({"tokens": torch.as_tensor(toks)})
    assert aux == 0.0
    np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)


def test_gemma2_prefill_and_decode_past_the_window(gemma):
    """Ragged prompts of 70-150 tokens (every one longer than the window),
    then 8 decode steps; the cache is compared within each row's length."""
    cfg, ref, params, port = gemma
    assert cfg.sliding_window < 70
    lens = np.array([70, 150, 111], np.int32)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 150)).astype(np.int32)
    max_len = 160
    r_logits, r_cache = ref.prefill(params, {"tokens": jnp.asarray(toks)}, max_len,
                                    lengths=jnp.asarray(lens))
    p_logits, p_cache = port.prefill({"tokens": torch.as_tensor(toks)}, max_len,
                                     lengths=torch.as_tensor(lens))
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
    lengths = lens.copy()
    nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    for step in range(8):
        r_logits, r_cache = ref.decode_step(params, r_cache, jnp.asarray(nxt),
                                            jnp.asarray(lengths))
        p_logits, p_cache = port.decode_step(p_cache, torch.as_tensor(nxt),
                                             torch.as_tensor(lengths))
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL,
                                   err_msg=f"decode step {step}")
        lengths = lengths + 1
        nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    for name in ("k", "v"):
        for b, n in enumerate(lengths):
            np.testing.assert_allclose(p_cache[name][:, b, :, :n].numpy(),
                                       np.asarray(r_cache[name])[:, b, :, :n], **TOL)


def test_gemma2_serve_engine_equals_reference(gemma):
    """Ragged prompts around the window through both ServeEngines, and a row
    alone equal to the same row in the batch."""
    cfg, ref, params, port = gemma
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (12, 90, 70)]
    port_out = ServeEngine(port, batch_slots=3, max_len=100).run(
        [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    ref_out = RefServeEngine(ref, params, batch_slots=3, max_len=100).run(
        [RefRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    assert port_out == ref_out
    solo = ServeEngine(port, batch_slots=1, max_len=100).run(
        [Request(uid=0, prompt=prompts[1], max_new_tokens=6)])[0]
    assert solo == port_out[1]
