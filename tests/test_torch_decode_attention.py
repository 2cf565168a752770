"""The port's decode attention against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``repro.kernels`` (the Pallas
kernel in interpret mode and its pure-jnp oracle) and through
``repro_torch.kernels.ops.decode_attention`` on CPU tensors, which takes
the kernel's plain PyTorch version.  Tolerance: rtol = atol = 2e-4, the
reference's band (``tests/test_kernels.py``); 1e-4 for length 1, where the
output is the first value row.  The CUDA kernel itself runs only on a card
(``test_cuda_kernel_matches_plain``, skipped here; ``chip_smoke.py`` drives
it at the serving path's shapes).  ``_emulate`` repeats the kernel's
arithmetic in plain PyTorch (chunks from the wrapper's rule, warps over
sub-tiles with an online softmax, warps then chunks combined in order) and
is held to the same band.
"""
import inspect
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_decode_attention
from repro.kernels import decode_attention_ref as jax_decode_attention_ref
from repro_torch.kernels import decode_attention, decode_attention_ref, ops
from repro_torch.kernels.decode_attention import (WARPS, chunk_positions, sub_tile_rows,
                                                  window_positions, workspace, workspace_numel)

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


# ---------------------------------------------------------------------------
# the kernel's decomposition, emulated on the CPU
# ---------------------------------------------------------------------------
def _merge(states):
    """(m, l, acc) partials in log2 units combined in list order, as the
    kernel combines warps, then chunks."""
    m = torch.stack([st[0] for st in states]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(states[0][2])
    for mi, li, ai in states:
        e = torch.exp2(mi - m)
        l = l + li * e
        acc = acc + ai * e[..., None]
    return m, l, acc


def _emulate(q, k_cache, v_cache, length, window=None, softcap=0.0):
    """The kernel's arithmetic: chunks of ``chunk_positions`` positions;
    in each, warp w takes sub-tiles w, w + WARPS, ... of ``sub_tile_rows``
    rows with an online softmax across them; warps and then chunks are
    combined in order.  Positions past a length are never touched.  With a
    window, lo = max(0, len - window): only the live chunks c_lo = lo //
    chunk .. c_hi run and are combined, the warps of the first live chunk
    start at the sub-tile holding lo, and its rows below lo are left out;
    a softcap applies in natural units before the log2(e) factor."""
    elem = k_cache.element_size()
    q, k, v = q.float(), k_cache.float(), v_cache.float()
    b, kv, gq, dh = q.shape
    s = k.shape[2]
    chunk, rows = chunk_positions(s, dh, elem), sub_tile_rows(dh, elem)
    window = window_positions(window, s)
    scale = math.log2(math.e) / math.sqrt(dh)
    out = torch.zeros((b, kv, gq, dh))
    for bi in range(b):
        n_len = min(int(length[bi]), s)
        lo = max(0, n_len - window)
        chunks = []
        for start in range(lo // chunk * chunk, n_len, chunk):
            n = min(chunk, n_len - start)
            skip = max(lo - start, 0)
            s_lo = skip // rows
            warps = []
            for w in range(WARPS):
                m = torch.full((kv, gq), -math.inf)
                l = torch.zeros((kv, gq))
                acc = torch.zeros((kv, gq, dh))
                for r0 in range((s_lo + w) * rows, n, WARPS * rows):
                    sl = slice(start + max(r0, skip), start + min(r0 + rows, n))
                    sc = torch.einsum("kgd,krd->kgr", q[bi], k[bi, :, sl])
                    if softcap > 0:
                        sc = softcap * torch.tanh(sc / math.sqrt(dh) / softcap) * math.log2(math.e)
                    else:
                        sc = sc * scale
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum("kgr,krd->kgd", p, v[bi, :, sl])
                    m = m_new
                warps.append((m, l, acc))
            chunks.append(_merge(warps))
        _, l, acc = _merge(chunks)
        out[bi] = acc / l.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("gq,dh", [(5, 32), (5, 256), (16, 32), (16, 256)])
def test_kernel_decomposition_matches_reference(gq, dh, dtype):
    """Lengths 1, chunk - 1, chunk, chunk + 1 and S, at an S that is not a
    multiple of the chunk, against the plain version and the JAX kernel."""
    s = 700
    _, q, k, v = _inputs(30 + gq + dh, 5, 2, gq, s, dh)
    kt, vt = torch.as_tensor(k).to(dtype), torch.as_tensor(v).to(dtype)
    chunk = chunk_positions(s, dh, kt.element_size())
    assert s % chunk and 1 < chunk < s
    length = np.array([1, chunk - 1, chunk, chunk + 1, s], np.int32)
    emu = _emulate(torch.as_tensor(q), kt, vt, length).numpy()
    port, ker, ref = _both(q, kt.float().numpy(), vt.float().numpy(), length)
    np.testing.assert_allclose(emu, ref, **TOL)
    np.testing.assert_allclose(emu, ker, **TOL)
    np.testing.assert_allclose(emu, port, **TOL)


def test_kernel_decomposition_qwen3_serving_shape():
    """qwen3-14b's heads at the serving cache length (S = 2088, bf16): 33
    chunks of 64 positions, one sub-tile a warp each."""
    _, q, k, v = _inputs(31, 2, 8, 5, 2088, 128)
    kt, vt = torch.as_tensor(k).to(torch.bfloat16), torch.as_tensor(v).to(torch.bfloat16)
    length = torch.tensor([2088, 1000], dtype=torch.int32)
    emu = _emulate(torch.as_tensor(q), kt, vt, length)
    torch.testing.assert_close(emu, decode_attention_ref(torch.as_tensor(q), kt, vt, length),
                               **TOL)


def test_emulated_row_alone_equals_row_in_batch():
    """The chunking never looks at the batch: a row alone is split, summed
    and combined exactly as in the batch, so the emulation gives equal bits."""
    _, q, k, v = _inputs(32, 4, 2, 5, 700, 128)
    qt, kt, vt = map(torch.as_tensor, (q, k, v))
    length = torch.tensor([700, 65, 1, 333], dtype=torch.int32)
    batch = _emulate(qt, kt, vt, length)
    for r in range(4):
        alone = _emulate(qt[r:r + 1], kt[r:r + 1], vt[r:r + 1], length[r:r + 1])
        assert torch.equal(alone[0], batch[r])


@pytest.mark.parametrize("softcap", [0.0, 50.0], ids=["nocap", "cap50"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("gq,dh", [(2, 256), (5, 128)], ids=["gemma2", "qwen3"])
def test_kernel_decomposition_window_matches_reference(gq, dh, dtype, softcap):
    """The live-chunk range c_lo..c_hi: windows of 101 (no multiple of a
    sub-tile or a chunk) and of more than a chunk, lengths below and above
    them, at gemma2's and qwen3's heads, against the plain version and the
    JAX package's decode_attention_xla; then a row alone equals the same row
    in the batch, bitwise."""
    from repro.models.layers import decode_attention_xla

    s = 1500
    _, q, k, v = _inputs(33 + gq, 5, 2, gq, s, dh)
    q = q * 10.0                      # scores of tens, so a cap of 50 bends them
    kt, vt = torch.as_tensor(k).to(dtype), torch.as_tensor(v).to(dtype)
    chunk = chunk_positions(s, dh, kt.element_size())
    for window in (101, chunk + 37):
        assert window % sub_tile_rows(dh, kt.element_size()) and window % chunk
        length = torch.tensor([1, window - 1, window + 1, 2 * chunk + 5, s], dtype=torch.int32)
        qt = torch.as_tensor(q)
        emu = _emulate(qt, kt, vt, length, window, softcap)
        plain = decode_attention_ref(qt, kt, vt, length, window, softcap)
        ref = decode_attention_xla(jnp.asarray(q), jnp.asarray(kt.float().numpy()),
                                   jnp.asarray(vt.float().numpy()), jnp.asarray(length.numpy()),
                                   window=window, attn_softcap=softcap)
        torch.testing.assert_close(emu, plain, **TOL)
        np.testing.assert_allclose(emu.numpy(), np.asarray(ref), **TOL)
        for r in (1, 3):
            alone = _emulate(qt[r:r + 1], kt[r:r + 1], vt[r:r + 1], length[r:r + 1], window,
                             softcap)
            assert torch.equal(alone[0], emu[r])


def test_kernel_decomposition_window_never_reads_outside():
    """NaN below len - window and from len on leaves the emulation finite
    and unchanged: its slices never reach them."""
    _, q, k, v = _inputs(34, 3, 2, 5, 700, 128)
    qt, kt, vt = map(torch.as_tensor, (q, k, v))
    length = torch.tensor([700, 333, 90], dtype=torch.int32)
    clean = _emulate(qt, kt, vt, length, 100)
    kn, vn = kt.clone(), vt.clone()
    for r, n in enumerate(length.tolist()):
        for t in (kn, vn):
            t[r, :, :max(0, n - 100)] = float("nan")
            t[r, :, n:] = float("nan")
    assert torch.equal(_emulate(qt, kn, vn, length, 100), clean)


# ---------------------------------------------------------------------------
# the chunk-size rule and the workspace it sizes
# ---------------------------------------------------------------------------
def test_chunk_rule_takes_no_batch_or_lengths():
    assert list(inspect.signature(chunk_positions).parameters) == ["s", "dh", "elem"]


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_chunk_rule_tiles_whole_passes(dh, elem):
    rows = sub_tile_rows(dh, elem)
    assert rows * dh * elem * 2 == 8192 and (dh * elem) % 16 == 0 and dh * elem >= 64
    for s in (1, 17, 700, 2088, 4096, 20_000, 32768, 100_003, 1 << 21):
        chunk = chunk_positions(s, dh, elem)
        n_chunks = -(-s // chunk)
        assert chunk % (WARPS * rows) == 0
        assert chunk == WARPS * rows or n_chunks >= 17
        assert n_chunks <= 64          # the kernel's combine holds 64 chunks' weights


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
def test_chunk_rule_fills_the_card_at_b1(elem):
    """qwen3-14b's 8 kv heads at B=1 give >= 132 live blocks (one per H100
    SM) at every full-length S from 2088 on."""
    for s in (2088, 2089, 3000, 4095, 4096, 8191, 16384, 32768, 65536, 131072):
        assert 8 * -(-s // chunk_positions(s, 128, elem)) >= 132, s


def test_workspace_sized_by_rule_and_cached():
    b, kv, gq, dh, s = 3, 8, 5, 128, 2088
    nc = -(-s // chunk_positions(s, dh, 2))
    n_part, n_count = workspace_numel(b, kv, gq, dh, nc)
    assert n_part == b * kv * nc * gq * (dh + 2) and n_count == b * kv
    dev = torch.device("cpu")
    part, counters = workspace(dev, 0, b, kv, gq, dh, nc)
    assert part.numel() == n_part and part.dtype == torch.float32
    assert counters.dtype == torch.int32 and not counters.any()
    again = workspace(dev, 0, b, kv, gq, dh, nc)
    assert again[0] is part and again[1] is counters
    other_stream = workspace(dev, 1, b, kv, gq, dh, nc)
    assert other_stream[0] is not part


def test_workspace_pads_m_and_l_to_float4():
    """hymba's 5 kv heads x 5 query heads at B = 1 over 17 chunks: 425 rows
    of m and of l, each padded to 428, so acc starts 16-byte aligned."""
    n_part, _ = workspace_numel(1, 5, 5, 64, 17)
    assert n_part == 2 * 428 + 425 * 64 and (2 * 428) % 4 == 0


# ---------------------------------------------------------------------------
# one rank's KV heads of a cache held whole (kv0)
# ---------------------------------------------------------------------------
def _split_inputs(dtype, seed=31, b=4, kvc=4, kv=2, gq=2, s=300, dh=64):
    """q over ``kv`` of a (b, kvc, s, dh) cache's heads, the cache in
    ``dtype`` (int8 with its scales and a bf16 dequant), ragged lengths."""
    from repro_torch.models.layers import quantize_kv

    rng, q, k, v = _inputs(seed, b, kvc, gq, s, dh)
    q = torch.as_tensor(q[:, :kv])
    k, v = torch.as_tensor(k), torch.as_tensor(v)
    extra = {}
    if dtype == torch.int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        extra = dict(k_scale=ks, v_scale=vs, dequant_dtype=torch.bfloat16)
    else:
        k, v = k.to(dtype), v.to(dtype)
    length = torch.as_tensor(rng.integers(1, s + 1, b).astype(np.int32))
    return q, k, v, length, extra


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
def test_plain_version_reads_the_head_slice_in_place(dtype):
    """With kv0 the plain version equals, bit for bit, the plain version on
    a contiguous copy of the cache's heads kv0 .. kv0 + KV - 1 (and of
    their int8 scales), with and without a window and a softcap."""
    q, k, v, length, extra = _split_inputs(dtype)
    kv = q.shape[1]
    for kv0 in (0, 1, 2):
        heads = slice(kv0, kv0 + kv)
        sliced = {n: t[:, heads].contiguous() if n.endswith("scale") else t
                  for n, t in extra.items()}
        for window, cap in ((None, 0.0), (100, 50.0)):
            got = decode_attention(q, k, v, length, window=window, attn_softcap=cap, kv0=kv0,
                                   **extra)
            want = decode_attention(q, k[:, heads].contiguous(), v[:, heads].contiguous(),
                                    length, window=window, attn_softcap=cap, **sliced)
            assert got.shape == q.shape and torch.equal(got, want), (kv0, window)
            assert torch.equal(got, decode_attention_ref(q, k, v, length, window, cap,
                                                         kv0=kv0, **extra))


def test_head_slice_past_the_cache_raises():
    q, k, v, length, _ = _split_inputs(torch.float32)
    for kv0 in (3, -1, 4):
        with pytest.raises(ValueError, match="kv0"):
            decode_attention(q, k, v, length, kv0=kv0)
    with pytest.raises(ValueError, match="kv0"):
        decode_attention(torch.zeros((4, 5, 2, 64)), k, v, length, kv0=0)
    with pytest.raises(ValueError, match="do not match"):
        decode_attention(q, k, v, length)      # a slice of the heads names its kv0

