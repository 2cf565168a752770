"""The port's masked L2 top-k against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``repro.kernels`` (the Pallas
kernel in interpret mode and its pure-jnp oracle) and through
``repro_torch.kernels`` on CPU tensors, which take the kernel's plain
PyTorch version.  Distances: rtol = atol = 2e-4, the reference's band.
Ids: exactly equal on these tie-free inputs.  The CUDA kernel itself runs
only on a card (``test_cuda_kernel_matches_plain``, skipped here;
``chip_smoke.py`` drives it at the main path's shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index.flat import l2_topk as jax_l2_topk
from repro.kernels import masked_l2_topk as jax_masked_l2_topk
from repro.kernels import masked_l2_topk_ref as jax_masked_l2_topk_ref
from repro_torch.kernels import masked_l2, ops
from repro_torch.kernels import masked_l2_topk, masked_l2_topk_ref, fused_masked_topk

TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(rng, shape, dtype=np.float32):
    return rng.normal(0, 1, shape).astype(dtype)


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("b,n,d", [(4, 600, 32), (128, 512, 128), (130, 1500, 200), (1, 512, 64),
                                   (256, 1024, 384)])
@pytest.mark.parametrize("k", [1, 10])
def test_masked_l2_shapes(b, n, d, k):
    rng = np.random.default_rng(b * 1000 + n + d + k)
    q, x = _rand(rng, (b, d)), _rand(rng, (n, d))
    mask = rng.random(n) < 0.5
    d_p, i_p = masked_l2_topk(_t(q), _t(x), _t(mask), k)
    d_k, i_k = jax_masked_l2_topk(q, x, jnp.asarray(mask), k, interpret=True)
    d_r, i_r = jax_masked_l2_topk_ref(jnp.asarray(q), jnp.asarray(x), jnp.asarray(mask), k)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_k), **TOL)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), **TOL)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    assert (i_p.numpy() == np.asarray(i_k)).mean() > 0.95


def test_masked_l2_all_masked_out():
    rng = np.random.default_rng(0)
    q, x = _rand(rng, (8, 64)), _rand(rng, (700, 64))
    d_p, i_p = masked_l2_topk(_t(q), _t(x), torch.zeros(700, dtype=torch.bool), 5)
    d_r, i_r = jax_masked_l2_topk_ref(jnp.asarray(q), jnp.asarray(x), jnp.zeros(700, bool), 5)
    assert (i_p.numpy() == -1).all() and (np.asarray(i_r) == -1).all()
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_r))        # BIG, as the raw kernel


def test_masked_l2_selective_mask_semantics():
    rng = np.random.default_rng(1)
    q, x = _rand(rng, (4, 32)), _rand(rng, (1024, 32))
    mask = np.zeros(1024, bool)
    mask[100:200] = True
    _, i_p = masked_l2_topk(_t(q), _t(x), _t(mask), 8)
    _, i_k = jax_masked_l2_topk(q, x, jnp.asarray(mask), 8, interpret=True)
    i_p = i_p.numpy()
    assert (((i_p >= 100) & (i_p < 200)) | (i_p == -1)).all()
    np.testing.assert_array_equal(i_p, np.asarray(i_k))


def test_masked_l2_padding_never_returned():
    rng = np.random.default_rng(2)
    q, x = _rand(rng, (4, 48)), _rand(rng, (513, 48))
    _, i_p = masked_l2_topk(_t(q), _t(x), torch.ones(513, dtype=torch.bool), 10)
    assert (i_p.numpy() < 513).all() and (i_p.numpy() >= 0).all()


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-4), (np.float16, 2e-2)])
def test_masked_l2_dtypes(dtype, tol):
    rng = np.random.default_rng(3)
    q, x = _rand(rng, (8, 64), dtype), _rand(rng, (600, 64), dtype)
    mask = np.ones(600, bool)
    d_p, _ = masked_l2_topk(_t(q), _t(x), _t(mask), 4)
    d_r, _ = jax_masked_l2_topk_ref(
        jnp.asarray(q, jnp.float32), jnp.asarray(x, jnp.float32), jnp.asarray(mask), 4)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), rtol=tol, atol=tol)


def test_masked_l2_ties_lowest_id_wins():
    """Every corpus row appears twice: each tie must resolve to the lower
    id, as jax.lax.top_k resolves it."""
    rng = np.random.default_rng(4)
    q = _rand(rng, (6, 16))
    base = _rand(rng, (300, 16))
    x = np.concatenate([base, base])
    mask = np.ones(600, bool)
    d_p, i_p = masked_l2_topk(_t(q), _t(x), _t(mask), 10)
    d_r, i_r = jax_masked_l2_topk_ref(jnp.asarray(q), jnp.asarray(x), jnp.asarray(mask), 10)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), **TOL)
    # slot pairs (2j, 2j+1) are one row and its duplicate, lowest first
    assert (i_p.numpy()[:, 0::2] < 300).all()
    np.testing.assert_array_equal(i_p.numpy()[:, 1::2], i_p.numpy()[:, 0::2] + 300)


def test_fused_masked_topk_inf_convention_and_ledger():
    rng = np.random.default_rng(5)
    q, x = _rand(rng, (3, 40)), _rand(rng, (900, 40))
    mask = np.zeros(900, bool)
    mask[:4] = True
    ops.reset_dispatch_stats()
    d_p, i_p = fused_masked_topk(_t(q), _t(x), _t(mask), 6)
    assert ops.dispatch_counts() == {"fused_masked_topk": 1}
    assert np.isinf(d_p.numpy()[:, 4:]).all() and (i_p.numpy()[:, 4:] == -1).all()
    d_j, i_j = jax_l2_topk(jnp.asarray(q), jnp.asarray(x), 6, jnp.asarray(mask))
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), **TOL)


def test_fused_masked_topk_k_above_kernel_lists():
    """k > KPAD takes index.flat.l2_topk, recorded under its own name."""
    rng = np.random.default_rng(6)
    q, x = _rand(rng, (2, 24)), _rand(rng, (400, 24))
    mask = rng.random(400) < 0.8
    k = ops.KPAD + 22
    ops.reset_dispatch_stats()
    d_p, i_p = fused_masked_topk(_t(q), _t(x), _t(mask), k)
    assert ops.dispatch_counts() == {"fused_masked_topk_l2_topk": 1}
    d_j, i_j = jax_l2_topk(jnp.asarray(q), jnp.asarray(x), k, jnp.asarray(mask))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), **TOL)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    with pytest.raises(ValueError):
        masked_l2_topk(_t(q), _t(x), _t(mask), k)


def test_kernel_matches_flat_index():
    rng = np.random.default_rng(11)
    q, x = _rand(rng, (16, 96)), _rand(rng, (2048, 96))
    mask = rng.random(2048) < 0.3
    d_p, _ = masked_l2_topk(_t(q), _t(x), _t(mask), 10)
    d_f, _ = jax_l2_topk(jnp.asarray(q), jnp.asarray(x), 10, jnp.asarray(mask))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_f), **TOL)


def test_cpu_tensors_never_launch_the_kernel():
    rng = np.random.default_rng(12)
    masked_l2.reset_launches()
    masked_l2_topk(_t(_rand(rng, (2, 8))), _t(_rand(rng, (50, 8))), torch.ones(50, dtype=torch.bool), 3)
    assert masked_l2.launches == 0


def test_split_plan_covers_the_corpus():
    for b, n in [(1, 16), (8, 2_140_000), (256, 2_140_000), (64, 1 << 19), (3, 0)]:
        for qt, bpsm in [(None, masked_l2.BLOCKS_PER_SM), (32, 1), (64, 1)]:
            splits, rows = masked_l2.split_plan(b, n, 132, qt, bpsm)
            assert rows % masked_l2.TN == 0 and splits >= 1
            assert splits * rows >= n and (splits - 1) * rows < max(n, 1)
            qtiles = -(-b // (qt or masked_l2.query_tile(b)))
            assert splits == 1 or qtiles * splits <= bpsm * 132    # one wave at most


PLAN_SHAPES = [(b, n, d, k) for b in (1, 8, 9, 16, 31, 32, 63, 64, 128, 256, 1024)
               for n in (16, 513, 4095, 4096, 1 << 19, 2_140_000) for d in (384, 36, 32, 30, 768, 1536)
               for k in (1, 10, 81, 82, 128)]


def test_plan_depends_on_shape_and_sms_only():
    """The path, tile and splits follow (B, N, d, k, SMs); the tiled path
    needs B >= TILED_MIN_B, N >= TILED_MIN_N, d % 4 == 0 and an aligned
    corpus; every
    tile it picks fits in shared memory, also at k = 128; splits cover N."""
    ml = masked_l2
    for b, n, d, k in PLAN_SHAPES:
        p = ml.plan(b, n, d, k, 132)
        assert p == ml.plan(b, n, d, k, 132)
        assert p.smem == ml.smem_bytes(p.qt, d, k) and p.smem <= ml.SMEM_MAX
        tiled_ok = b >= ml.TILED_MIN_B and n >= ml.TILED_MIN_N and d % 4 == 0
        fits = any(ml.smem_bytes(qt, d, k) <= ml.SMEM_MAX for qt in ml.TILED_QT)
        assert (p.path == "tiled") == (tiled_ok and fits), (b, n, d, k, p)
        if p.path == "tiled":
            assert p.qt in ml.TILED_QT and (p.qt <= b or p.qt == min(ml.TILED_QT))
            wider = [qt for qt in ml.TILED_QT if p.qt < qt <= b]
            assert all(ml.smem_bytes(qt, d, k) > ml.SMEM_MAX for qt in wider)
            assert (p.splits, p.rows_per_split) == ml.split_plan(b, n, 132, p.qt, 1)
        else:
            assert p.qt == ml.query_tile(b)
        assert p.splits * p.rows_per_split >= n and (p.splits - 1) * p.rows_per_split < max(n, 1)
        assert ml.plan(b, n, d, k, 132, aligned=False).path == "streaming"
    # d = 384 (the arxiv width), every k the kernel takes: tiled from B = TILED_MIN_B
    for k in range(1, ml.KPAD + 1):
        assert ml.plan(256, 2_140_000, 384, k, 132).path == "tiled"
        assert ml.plan(ml.TILED_MIN_B, 1 << 19, 384, k, 132).path == "tiled"
        assert ml.plan(ml.TILED_MIN_B - 1, 2_140_000, 384, k, 132).path == "streaming"
        assert ml.plan(256, ml.TILED_MIN_N - 1, 384, k, 132).path == "streaming"
    assert ml.plan(256, 2_140_000, 384, 10, 132).qt == 64
    assert ml.plan(256, 2_140_000, 384, 128, 132).qt == 32
    assert ml.plan(32, 2_140_000, 384, 10, 132).qt == 32


def _lex_topk(cands, k):
    """The k smallest (dist, id) keys: a tuple compares as lex_less does."""
    return sorted(cands)[:k]


def tiled_selection_model(d2, mask, k, rows_per_split, tile, cap, seed):
    """A plain-Python model of the tiled path's selection: per split, tiles
    of `tile` passing rows in ascending order; after each tile, the
    candidates lex_less than the query's k-th key tau are appended to a
    buffer of `cap` entries in a random (atomic) order, the buffer is merged
    into the sorted list when full or at the tile's end, and a candidate
    that found it full is filtered again by the new tau.  Then the split
    lists merge.  Returns (dists, ids) as masked_l2_topk_ref does."""
    rng = np.random.default_rng(seed)
    b, n = d2.shape
    inf = (float("inf"), 2**31 - 1)
    out_d = np.full((b, k), np.float32(BIG_), np.float32)
    out_i = np.full((b, k), -1, np.int32)
    for qb in range(b):
        partial = []
        for r0 in range(0, max(n, 1), rows_per_split):
            rows = [r for r in range(r0, min(n, r0 + rows_per_split)) if mask[r]]
            lst = []
            for t0 in range(0, len(rows), tile):
                pending = [(float(d2[qb, r]), r) for r in rows[t0:t0 + tile]]
                while pending:
                    rng.shuffle(pending)
                    tau = lst[k - 1] if len(lst) == k else inf
                    admitted = [c for c in pending if c < tau]
                    buf, pending = admitted[:cap], admitted[cap:]
                    lst = _lex_topk(lst + buf, k)
            partial += lst
        best = _lex_topk(partial, k)
        for s, (dv, r) in enumerate(best):
            out_d[qb, s], out_i[qb, s] = dv, r
    return out_d, out_i


BIG_ = masked_l2.BIG


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("tile,cap", [(16, 4), (16, 16), (128, 64), (64, 7)])
def test_tiled_selection_model_matches_plain(k, tile, cap):
    """Tie-heavy inputs (every row three times, some rows exactly at a
    query): the model's ids equal masked_l2_topk_ref's and the JAX
    reference's bitwise, whatever order the atomics append in."""
    rng = np.random.default_rng(k * 100 + tile + cap)
    base = _rand(rng, (100, 16))
    x = np.concatenate([base, base, base])
    q = np.concatenate([base[:2], _rand(rng, (3, 16))])
    mask = rng.random(300) < 0.7
    d_r, i_r = masked_l2_topk_ref(_t(q), _t(x), _t(mask), k)
    q_t, x_t = _t(q), _t(x)
    d2 = torch.clamp_min((q_t * q_t).sum(1, keepdim=True) + (x_t * x_t).sum(1)[None, :]
                         - 2.0 * (q_t @ x_t.T), 0.0).numpy()
    runs = [tiled_selection_model(d2, mask, k, 96, tile, cap, seed) for seed in (0, 1)]
    for d_m, i_m in runs:
        np.testing.assert_array_equal(i_m, i_r.numpy())
        np.testing.assert_array_equal(d_m, d_r.numpy())
    _, i_j = jax_masked_l2_topk_ref(jnp.asarray(q), jnp.asarray(x), jnp.asarray(mask), k)
    np.testing.assert_array_equal(runs[0][1], np.asarray(i_j))


def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    rng = np.random.default_rng(13)
    dev = torch.device("cuda")
    q = torch.as_tensor(_rand(rng, (9, 384)), device=dev)
    x = torch.as_tensor(_rand(rng, (5000, 384)), device=dev)
    m = torch.as_tensor(rng.random(5000) < 0.5, device=dev)
    d_k, i_k = masked_l2_topk(q, x, m, 10)
    d_r, i_r = masked_l2_topk_ref(q, x, m, 10)
    torch.testing.assert_close(d_k, d_r, **TOL)
    assert torch.equal(i_k, i_r)
    # the tiled path: B=256 over more than TILED_MIN_N rows; a row alone
    # (B=1, the streaming path) equals the same row in the batch, bitwise
    n = masked_l2.TILED_MIN_N + 3000
    q = torch.as_tensor(_rand(rng, (256, 384)), device=dev)
    x = torch.as_tensor(_rand(rng, (n, 384)), device=dev)
    m = torch.as_tensor(rng.random(n) < 0.5, device=dev)
    assert masked_l2.plan(256, n, 384, 10, 132).path == "tiled"
    d_k, i_k = masked_l2_topk(q, x, m, 10)
    d_r, i_r = masked_l2_topk_ref(q, x, m, 10)
    torch.testing.assert_close(d_k, d_r, **TOL)
    assert (i_k == i_r).float().mean() > 0.95   # sums in another order: near-ties may swap
    for r in (0, 1, 100, 255):
        d_1, i_1 = masked_l2_topk(q[r:r + 1].clone(), x, m, 10)
        assert torch.equal(d_1[0], d_k[r]) and torch.equal(i_1[0], i_k[r])
