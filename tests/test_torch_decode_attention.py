"""The port's decode attention against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``repro.kernels`` (the Pallas
kernel in interpret mode and its pure-jnp oracle) and through
``repro_torch.kernels.ops.decode_attention`` on CPU tensors, which takes
the kernel's plain PyTorch version.  Tolerance: rtol = atol = 2e-4, the
reference's band (``tests/test_kernels.py``); 1e-4 for length 1, where the
output is the first value row.  The CUDA kernel itself runs only on a card
(``test_cuda_kernel_matches_plain``, skipped here; ``chip_smoke.py`` drives
it at the serving path's shapes).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_decode_attention
from repro.kernels import decode_attention_ref as jax_decode_attention_ref
from repro_torch.kernels import decode_attention, decode_attention_ref, ops

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, b, kv, gq, s, dh):
    rng = np.random.default_rng(seed)
    q = (rng.normal(0, 1, (b, kv, gq, dh)) * 0.1).astype(np.float32)
    k = (rng.normal(0, 1, (b, kv, s, dh)) * 0.1).astype(np.float32)
    v = rng.normal(0, 1, (b, kv, s, dh)).astype(np.float32)
    return rng, q, k, v


def _both(q, k, v, length):
    port = decode_attention(*map(torch.as_tensor, (q, k, v, length)))
    ker = jax_decode_attention(q, k, v, jnp.asarray(length), interpret=True)
    ref = jax_decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(length))
    return port.numpy(), np.asarray(ker), np.asarray(ref)


@pytest.mark.parametrize(
    "b,kv,gq,s,dh",
    [(2, 4, 2, 1024, 64), (1, 2, 8, 512, 128), (3, 1, 4, 1536, 64), (2, 8, 1, 512, 128)],
)
def test_decode_attention_shapes(b, kv, gq, s, dh):
    rng, q, k, v = _inputs(b + kv + gq + s, b, kv, gq, s, dh)
    length = rng.integers(1, s + 1, b).astype(np.int32)
    port, ker, ref = _both(q, k, v, length)
    assert port.dtype == np.float32 and port.shape == (b, kv, gq, dh)
    np.testing.assert_allclose(port, ker, **TOL)
    np.testing.assert_allclose(port, ref, **TOL)


def test_decode_attention_unpadded_length():
    """S = 700 is not a multiple of the TPU tile; the port pads nothing."""
    _, q, k, v = _inputs(9, 2, 2, 2, 700, 64)
    port, ker, ref = _both(q, k, v, np.array([700, 350], np.int32))
    np.testing.assert_allclose(port, ker, **TOL)
    np.testing.assert_allclose(port, ref, **TOL)


def test_decode_attention_qwen3_heads():
    """qwen3-14b's heads (KV 8, GQ 5, dh 128) at S = 700, lengths 1, 350, 700."""
    _, q, k, v = _inputs(12, 3, 8, 5, 700, 128)
    port, ker, ref = _both(q, k, v, np.array([1, 350, 700], np.int32))
    np.testing.assert_allclose(port, ker, **TOL)
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(port[0], np.broadcast_to(v[0, :, 0:1, :], (8, 5, 128)),
                               rtol=1e-4, atol=1e-4)


def test_decode_attention_length_one():
    rng = np.random.default_rng(10)
    q = rng.normal(0, 1, (1, 2, 4, 64)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, 512, 64)).astype(np.float32)
    v = rng.normal(0, 1, (1, 2, 512, 64)).astype(np.float32)
    out = decode_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                           torch.tensor([1], dtype=torch.int32))
    # attention over a single key = that key's value
    np.testing.assert_allclose(out.numpy()[0], np.broadcast_to(v[0, :, 0:1, :], (2, 4, 64)),
                               rtol=1e-4, atol=1e-4)


def test_decode_attention_bf16_cache():
    """A bf16 cache is widened to f32 inside; the reference sees the same
    bf16-rounded values in f32."""
    rng, q, k, v = _inputs(21, 2, 8, 5, 700, 128)
    kb = torch.as_tensor(k).to(torch.bfloat16)
    vb = torch.as_tensor(v).to(torch.bfloat16)
    length = np.array([513, 700], np.int32)
    port = decode_attention(torch.as_tensor(q), kb, vb, torch.as_tensor(length))
    assert port.dtype == torch.float32
    ref = jax_decode_attention_ref(jnp.asarray(q), jnp.asarray(kb.float().numpy()),
                                   jnp.asarray(vb.float().numpy()), jnp.asarray(length))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("gq,dh", [(5, 96), (17, 128), (4, 48), (0, 128)])
def test_decode_attention_rejects_unsupported_heads(gq, dh):
    q = torch.zeros((1, 2, gq, dh))
    kc = torch.zeros((1, 2, 64, dh))
    with pytest.raises(ValueError):
        decode_attention(q, kc, kc, torch.tensor([8], dtype=torch.int32))


def test_decode_attention_rejects_mismatched_shapes():
    q = torch.zeros((2, 2, 5, 128))
    with pytest.raises(ValueError):
        decode_attention(q, torch.zeros((2, 4, 64, 128)), torch.zeros((2, 4, 64, 128)),
                         torch.tensor([8, 8], dtype=torch.int32))
    with pytest.raises(ValueError):
        decode_attention(q, torch.zeros((2, 2, 64, 128)), torch.zeros((2, 2, 64, 128)),
                         torch.tensor([8], dtype=torch.int32))


def test_decode_attention_records_dispatch_not_launch():
    """On the CPU the plain version runs: a dispatch is recorded, no launch."""
    ops.reset_dispatch_stats()
    ops.reset_kernel_launches()
    _, q, k, v = _inputs(23, 1, 2, 5, 256, 128)
    decode_attention(*map(torch.as_tensor, (q, k, v, np.array([256], np.int32))))
    assert ops.dispatch_counts() == {"decode_attention": 1}
    assert ops.kernel_launches() == {"masked_l2_topk": 0, "decode_attention": 0}
    ref = decode_attention_ref(*map(torch.as_tensor, (q, k, v, np.array([256], np.int32))))
    assert ref.shape == (1, 2, 5, 128)


def test_cuda_wrapper_refuses_cpu_tensors_before_building():
    """The kernel's own wrapper checks its inputs before it builds or loads
    anything: CPU tensors are refused, not run some other way."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    _, q, k, v = _inputs(25, 1, 2, 5, 64, 128)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(*map(torch.as_tensor, (q, k, v, np.array([64], np.int32))))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    import shutil

    from repro_torch.kernels import nvcc

    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present: the build would run")
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "k.cu"
    src.write_text("// empty")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc.build_library(src)
    assert not (tmp_path / "_build").exists()


def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        _, q, k, v = _inputs(24, 4, 8, 5, 2088, 128)
        qt = torch.as_tensor(q, device=dev)
        kt = torch.as_tensor(k, device=dev).to(dtype)
        vt = torch.as_tensor(v, device=dev).to(dtype)
        length = torch.tensor([1, 256, 1000, 2088], dtype=torch.int32, device=dev)
        torch.testing.assert_close(decode_attention(qt, kt, vt, length),
                                   decode_attention_ref(qt, kt, vt, length), **TOL)
