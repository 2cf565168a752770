"""The decode kernel reading one rank's KV heads of a whole cache, on a card.

Tensor-parallel serving keeps the KV cache whole on every rank and each
rank attends over its own KV groups: the kernel takes the first head
``kv0`` and reads the heads ``kv0 .. kv0 + KV - 1`` of the (B, KV_cache, S,
dh) cache in place.  Held here to the plain version on the same heads at
gemma2-2b's split shape (cache KV 4, 2 a rank, GQ 2, dh 256, window 4096,
softcap 50), bf16 and int8, rtol = atol = 2e-4 (the reference's kernel
band).  This file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_attention_cuda.py

Without a card the test skips (``chip_smoke.py`` phase 3f runs the same
rows); the CPU tests of ``kv0`` are in ``test_torch_decode_attention.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention, decode_attention_ref
from repro_torch.models.layers import quantize_kv

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_cuda_kernel_head_slice_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    b, kvc, kv, gq, s, dh = 4, 4, 2, 2, 8192, 256
    q = torch.as_tensor(rng.normal(0, 1, (b, kv, gq, dh)).astype(np.float32), device=dev)
    k = torch.as_tensor(rng.normal(0, 1, (b, kvc, s, dh)).astype(np.float32), device=dev)
    v = torch.as_tensor(rng.normal(0, 1, (b, kvc, s, dh)).astype(np.float32), device=dev)
    extra = {}
    if dtype == torch.int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        extra = dict(k_scale=ks, v_scale=vs, dequant_dtype=torch.bfloat16)
    else:
        k, v = k.to(dtype), v.to(dtype)
    length = torch.tensor([1, 4000, 4097, 8192], dtype=torch.int32, device=dev)
    for kv0 in (0, 2):
        got = decode_attention(q, k, v, length, window=4096, attn_softcap=50.0, kv0=kv0, **extra)
        want = decode_attention_ref(q, k, v, length, 4096, 50.0, kv0=kv0, **extra)
        torch.testing.assert_close(got, want, **TOL)
