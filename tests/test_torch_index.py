"""The port's flat index, k-means and IVF against the JAX package's.

Tolerances: distances rtol = atol = 2e-4; k-means centroids within 1e-4
(both run Lloyd from the same numpy-seeded init, with sums taken in a
different order).  The IVF is built through ``repro_torch.carry`` from the
reference index's own centroids and assignment, so both search one list
layout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index.flat import chunked_masked_topk as jax_chunked
from repro.index.flat import l2_topk as jax_l2_topk
from repro.index.ivf import IVFIndex as RefIVF
from repro.index.kmeans import kmeans as jax_kmeans
from repro_torch import carry
from repro_torch.index import FlatIndex, IVFIndex, chunked_masked_topk, kmeans, l2_topk

TOL = dict(rtol=2e-4, atol=2e-4)


def _clustered(rng, n, d, centers=12):
    c = rng.normal(0, 1, (centers, d)).astype(np.float32)
    return (c[rng.integers(centers, size=n)] + 0.3 * rng.normal(0, 1, (n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def ivf_pair():
    rng = np.random.default_rng(0)
    x = _clustered(rng, 3000, 48)
    ref = RefIVF(x, n_lists=40, seed=0).build(iters=4)
    assign = np.empty(x.shape[0], np.int64)
    for lst in range(ref.n_lists):
        assign[ref.sorted_ids[ref.offsets[lst]:ref.offsets[lst + 1]]] = lst
    port = carry.ivf_from_assignment(x, ref.centroids, assign, device="cpu")
    q = (x[rng.integers(3000, size=20)] + 0.05 * rng.normal(0, 1, (20, 48))).astype(np.float32)
    return x, q, ref, port


@pytest.mark.parametrize("masked", [False, True])
def test_l2_topk_matches_reference(masked):
    rng = np.random.default_rng(1)
    q, x = rng.normal(size=(7, 64)).astype(np.float32), rng.normal(size=(900, 64)).astype(np.float32)
    mask = rng.random(900) < 0.4 if masked else None
    d_p, i_p = l2_topk(torch.as_tensor(q), torch.as_tensor(x), 10,
                       None if mask is None else torch.as_tensor(mask))
    d_r, i_r = jax_l2_topk(jnp.asarray(q), jnp.asarray(x), 10,
                           None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), **TOL)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))


def test_chunked_and_flat_index_match_reference():
    rng = np.random.default_rng(2)
    q, x = rng.normal(size=(5, 32)).astype(np.float32), rng.normal(size=(1000, 32)).astype(np.float32)
    mask = rng.random(1000) < 0.6
    d_p, i_p = chunked_masked_topk(torch.as_tensor(q), torch.as_tensor(x), 8,
                                   torch.as_tensor(mask), chunk=256)
    d_r, i_r = jax_chunked(jnp.asarray(q), jnp.asarray(x), 8, jnp.asarray(mask), chunk=256)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), **TOL)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    d_f, i_f = FlatIndex(x, device="cpu").search(q, 8, mask)
    np.testing.assert_array_equal(i_f.numpy(), np.asarray(i_r))


def test_kmeans_matches_reference_from_same_init():
    rng = np.random.default_rng(3)
    x = _clustered(rng, 2000, 24, centers=6)
    c_p, a_p = kmeans(torch.as_tensor(x), 16, iters=4, seed=5)
    c_r, a_r = jax_kmeans(x, 16, iters=4, seed=5)
    np.testing.assert_allclose(c_p.numpy(), c_r, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(a_p.numpy(), a_r)


def test_kmeans_deterministic():
    rng = np.random.default_rng(4)
    x = torch.as_tensor(_clustered(rng, 1500, 16))
    c1, a1 = kmeans(x, 20, iters=3, seed=1)
    c2, a2 = kmeans(x, 20, iters=3, seed=1)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)


def test_carried_ivf_has_reference_layout(ivf_pair):
    _, _, ref, port = ivf_pair
    np.testing.assert_array_equal(port.sorted_ids.numpy(), ref.sorted_ids)
    np.testing.assert_array_equal(port.offsets, ref.offsets)
    np.testing.assert_array_equal(port.list_counts, ref.list_counts)
    np.testing.assert_allclose(port.sorted_sq.numpy(), ref.sorted_sq, rtol=1e-6)


@pytest.mark.parametrize("nprobe", [1, 8, 40])
def test_ivf_search_matches_reference(ivf_pair, nprobe):
    _, q, ref, port = ivf_pair
    d_p, i_p = port.search(q, 10, nprobe=nprobe)
    d_r, i_r = ref.search(q, 10, nprobe=nprobe)
    np.testing.assert_array_equal(i_p, i_r)
    np.testing.assert_allclose(d_p, d_r, **TOL)


def test_ivf_masked_search_matches_reference(ivf_pair):
    x, q, ref, port = ivf_pair
    mask = np.random.default_rng(5).random(x.shape[0]) < 0.3
    d_p, i_p = port.search(q, 10, nprobe=8, mask=mask)
    d_r, i_r = ref.search(q, 10, nprobe=8, mask=mask)
    np.testing.assert_array_equal(i_p, i_r)
    np.testing.assert_allclose(d_p, d_r, **TOL)
    assert mask[i_p[i_p >= 0]].all()


def test_ivf_row_independence(ivf_pair):
    """A row searched alone is bit-identical to the same row in a batch."""
    _, q, _, port = ivf_pair
    d_b, i_b = port.search(q, 10, nprobe=8)
    for r in (0, 7, 19):
        d_1, i_1 = port.search(q[r:r + 1], 10, nprobe=8)
        np.testing.assert_array_equal(i_1[0], i_b[r])
        np.testing.assert_array_equal(d_1[0], d_b[r])


def test_ivf_build_runs_kmeans():
    rng = np.random.default_rng(6)
    x = _clustered(rng, 800, 16)
    ivf = IVFIndex(x, n_lists=10, seed=0, device="cpu").build(iters=3)
    assert ivf.offsets[-1] == 800 and ivf.list_counts.sum() == 800
    _, ids = ivf.search(x[:3], 5, nprobe=10)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2])
