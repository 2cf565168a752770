"""The port's int8 KV cache against the JAX package's, on the CPU.

``quantize_kv`` / ``dequantize_kv`` equal the reference's bit for bit on
the same input, ties at a half included (both round half to even).  Then
qwen3-14b, gemma2-2b and hymba-1.5b ``reduced()`` with ``kv_cache_int8``,
in fp32, weights carried from the reference (``Model.init(PRNGKey(0))``),
as the reference's ``tests/test_kv_int8.py`` runs them.  After a prefill
of 70 tokens (past the 64-token windows of gemma2's and hymba's local
layers) the int8 cache and its scales equal, bit for bit, the reference's
``quantize_kv`` of the port's own fp32 K/V.  The two packages' fp32 K/V
differ by a few ulps (their matmuls sum in other orders), so against the
reference model's cache the scales agree within 2e-6 and an int8 value
may differ by 1 where those ulps cross a rounding boundary (1 of 19,968
values in two of six cases here), after the prefill and after each of four
decode steps.  The prefill's logits are within rtol = atol = 1e-4 of the
reference's.  Each decode step starts both packages from the reference's
cache and is held to 1e-4, or to 1e-3 when one of the step's new K/V
values rounded the other way (one step in twelve here: hymba's step 2,
4.9e-4): that value moves its layer's attention by a quantization step
times the new position's weight.

The decode attention's plain version with int8 caches equals
dequantize-then-float bitwise (it is that computation), and the wrapper
refuses a wrong dtype, shape or missing scale.  The CUDA kernel's int8
variant runs only on a card (``test_cuda_int8_kernel_matches_plain``,
skipped here; ``chip_smoke.py`` phase 3d drives it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models.layers import dequantize_kv as ref_dequantize_kv
from repro.models.layers import quantize_kv as ref_quantize_kv
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention, decode_attention_ref
from repro_torch.models.layers import dequantize_kv, quantize_kv

TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = 70


def test_quantize_kv_bitwise_equals_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (3, 4, 9, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # an all-zero vector: scale 1e-8
    # max 127 gives scale 1.0 exactly, so k + 0.5 is a tie that rounds to even
    x[0, 0, 1] = np.concatenate([[127.0], np.arange(63) - 31.5]).astype(np.float32)
    x[1, 2, 3, 5] = 1e30                               # one huge value
    rq, rs = ref_quantize_kv(jnp.asarray(x))
    pq, ps = quantize_kv(torch.as_tensor(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    assert pq[0, 0, 1, 1:5].tolist() == [-32, -30, -30, -28]   # half to even
    np.testing.assert_array_equal(dequantize_kv(pq, ps).numpy(),
                                  np.asarray(ref_dequantize_kv(rq, rs)))
    # bf16 input, as a bf16 model's K/V
    xb = torch.as_tensor(x[1:]).to(torch.bfloat16)
    rq, rs = ref_quantize_kv(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    pq, ps = quantize_kv(xb)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))


def _pair(arch, int8=True):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32",
                                  kv_cache_int8=int8)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", kv_cache_int8=int8)
    ref = RefModel(ref_cfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    port = carry.model_params_from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, ref, params, port


def _check_cache(p_cache, r_cache, n, what):
    """int8 K/V and scales at the n positions written, against the
    reference's: scales within 2e-6 (a few ulps: the packages' fp32 K/V
    differ by the order of their sums), int8 values within 1, at no more
    than 1 in 1000 positions (where those ulps cross a rounding boundary)."""
    for name in ("k", "v"):
        p_q, p_s = p_cache[name][:, :, :, :n], p_cache[f"{name}_scale"][:, :, :, :n]
        r_q = np.asarray(r_cache[name])[:, :, :, :n].astype(np.int32)
        r_s = np.asarray(r_cache[f"{name}_scale"])[:, :, :, :n]
        assert p_q.dtype == torch.int8 and p_s.dtype == torch.float32
        np.testing.assert_allclose(p_s.numpy(), r_s, rtol=2e-6, atol=0, err_msg=f"{what}: {name}")
        diff = np.abs(p_q.numpy().astype(np.int32) - r_q)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, \
            f"{what}: {name}: {int((diff > 0).sum())} of {diff.size} int8 values differ"


@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma2-2b", "hymba-1.5b"])
def test_int8_cache_and_logits_match_reference(arch):
    cfg, ref, params, port = _pair(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    max_len = PROMPT + 8
    r_logits, r_cache = jax.jit(lambda p, b: ref.prefill(p, b, max_len))(
        params, {"tokens": jnp.asarray(toks)})
    p_logits, p_cache = port.prefill({"tokens": torch.as_tensor(toks)}, max_len)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
    _check_cache(p_cache, r_cache, PROMPT, "prefill")
    # bit for bit: the prefill's int8 cache is the reference's quantize_kv of
    # the port's own fp32 K/V (an fp32-cache twin with the same weights)
    twin = carry.model_params_from_reference(dataclasses.replace(cfg, kv_cache_int8=False),
                                             jax.tree.map(np.asarray, params), device="cpu")
    _, f_cache = twin.prefill({"tokens": torch.as_tensor(toks)}, max_len)
    for name in ("k", "v"):
        r_q, r_s = ref_quantize_kv(jnp.asarray(f_cache[name][:, :, :, :PROMPT].numpy()))
        np.testing.assert_array_equal(p_cache[name][:, :, :, :PROMPT].numpy(), np.asarray(r_q))
        np.testing.assert_array_equal(p_cache[f"{name}_scale"][:, :, :, :PROMPT].numpy(),
                                      np.asarray(r_s))
    # decode: each step starts both packages from the reference's cache, so
    # an int8 value the prefill rounded the other way does not carry over
    lengths = np.full(2, PROMPT, np.int32)
    nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    ref_decode = jax.jit(ref.decode_step)
    for step in range(4):
        p_cache = {k: torch.as_tensor(np.array(v)) for k, v in r_cache.items()}
        r_logits, r_cache = ref_decode(params, r_cache, jnp.asarray(nxt), jnp.asarray(lengths))
        p_logits, _ = port.decode_step(p_cache, torch.as_tensor(nxt), torch.as_tensor(lengths))
        n = int(lengths[0])
        flips = sum(int((p_cache[k][:, :, :, n].numpy() != np.asarray(r_cache[k])[:, :, :, n]).sum())
                    for k in ("k", "v"))
        lengths = lengths + 1
        # a new row's int8 value rounded the other way moves that layer's
        # attention by up to a quantization step (1/127 of the vector's max)
        # times the row's weight: such a step is held to 1e-3
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits),
                                   **(TOL if not flips else dict(rtol=1e-3, atol=1e-3)),
                                   err_msg=f"decode step {step} ({flips} new int8 values differ)")
        _check_cache(p_cache, r_cache, int(lengths[0]), f"decode step {step}")
        nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)


def _int8_inputs(b=3, kv=2, gq=5, s=50, dh=64, seed=2):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(0, 1, (b, kv, gq, dh)).astype(np.float32))
    k, ks = quantize_kv(torch.as_tensor(rng.normal(0, 1, (b, kv, s, dh)).astype(np.float32)))
    v, vs = quantize_kv(torch.as_tensor(rng.normal(0, 1, (b, kv, s, dh)).astype(np.float32)))
    length = torch.tensor([s, 17, 1][:b], dtype=torch.int32)
    return q, k, v, ks, vs, length


@pytest.mark.parametrize("dequant", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_int8_equals_dequantize_then_float(dequant):
    q, k, v, ks, vs, length = _int8_inputs()
    for window, cap in ((None, 0.0), (13, 50.0)):
        got = decode_attention(q, k, v, length, window, cap, k_scale=ks, v_scale=vs,
                               dequant_dtype=dequant)
        want = decode_attention_ref(q, dequantize_kv(k, ks).to(dequant).float(),
                                    dequantize_kv(v, vs).to(dequant).float(), length, window, cap)
        assert torch.equal(got, want)


def test_int8_wrapper_refuses_wrong_inputs():
    q, k, v, ks, vs, length = _int8_inputs()
    with pytest.raises(TypeError, match="k_scale"):
        decode_attention(q, k, v, length)                              # no scales
    with pytest.raises(TypeError, match="k_scale"):
        decode_attention(q, k.float(), v.float(), length, k_scale=ks, v_scale=vs)
    with pytest.raises(TypeError, match="int8"):
        decode_attention(q, k, v.float(), length, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention(q, k, v, length, k_scale=ks[:, :, :-1], v_scale=vs)
    with pytest.raises(ValueError, match="v_scale"):
        decode_attention(q, k, v, length, k_scale=ks, v_scale=vs.double())
    with pytest.raises(TypeError, match="dequant_dtype"):
        decode_attention(q, k, v, length, k_scale=ks, v_scale=vs, dequant_dtype=torch.float16)
    with pytest.raises(ValueError, match="head dim"):
        q2, k2, v2, ks2, vs2, l2 = _int8_inputs(dh=48)
        decode_attention(q2, k2, v2, l2, k_scale=ks2, v_scale=vs2)


def test_cuda_int8_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py phase 3d runs it)")
    dev = torch.device("cuda")
    q, k, v, ks, vs, length = (t.to(dev) for t in _int8_inputs(s=2088, dh=128))
    for dequant in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(
            decode_attention(q, k, v, length, k_scale=ks, v_scale=vs, dequant_dtype=dequant),
            decode_attention_ref(q, k, v, length, k_scale=ks, v_scale=vs,
                                 dequant_dtype=dequant), rtol=2e-4, atol=2e-4)
