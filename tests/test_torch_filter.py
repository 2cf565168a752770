"""The port's numpy layer against the JAX package's, on the same arrays.

Bitmap words, popcount selectivity, ``SelEstimate`` and GBM predictions
must be bit-equal.  The port's copies of these modules are numpy code with
only their imports re-pointed, except ``filter/ranges.py``: its range index
keeps cumulative edge bitmaps where the JAX package keeps one bitmap a
bucket, so its words are held bit-equal to the JAX package's and to the
column scan case by case.
"""
import math

import numpy as np
import pytest

from repro.core import trainer as ref_trainer
from repro.core.gbm import GradientBoostingRegressor as RefGBM
from repro.core.selectivity import SelectivityEstimator as RefEstimator
from repro.core.stats import DatasetStats as RefStats
from repro.filter import AttributeIndex as RefIndex
from repro.filter import PredicateCache as RefCache
from repro.filter import RangeIndex as RefRangeIndex
from repro.filter import canonical_key as ref_key
from repro_torch import carry
from repro_torch.core import trainer
from repro_torch.core.gbm import GradientBoostingRegressor
from repro_torch.core.selectivity import SelectivityEstimator
from repro_torch.core.stats import DatasetStats
from repro_torch.data import make_dataset
from repro_torch.filter import AttributeIndex, PredicateCache, RangeIndex, canonical_key
from repro_torch.filter.bitmap import pack_mask


@pytest.fixture(scope="module")
def data():
    ds = make_dataset("arxiv", "3000", seed=0)
    # each package gets predicates of its own IR classes, from one seed
    _, preds, sels = trainer.gen_queries(ds.vectors, ds.cat, ds.num, 60,
                                         kinds=ds.filter_kinds, seed=2)
    _, rpreds, rsels = ref_trainer.gen_queries(ds.vectors, ds.cat, ds.num, 60,
                                               kinds=ds.filter_kinds, seed=2)
    return ds, preds, sels, rpreds, rsels


def test_gen_queries_equal(data):
    ds, preds, sels, rpreds, rsels = data
    assert [repr(p) for p in preds] == [repr(p) for p in rpreds]
    np.testing.assert_array_equal(sels, rsels)


def test_bitmap_words_and_popcount_equal(data):
    ds, preds, _, rpreds, _ = data
    idx = AttributeIndex.build(ds.cat, ds.num, 64)
    ref = RefIndex.build(ds.cat, ds.num, 64)
    for p, rp in zip(preds, rpreds):
        c, r = idx.compile(p), ref.compile(rp)
        np.testing.assert_array_equal(c.words, r.words)
        assert c.popcount == r.popcount and c.selectivity == r.selectivity
        np.testing.assert_array_equal(c.mask(), p.eval(ds.cat, ds.num))
        assert canonical_key(p) == ref_key(rp)


def test_predicate_cache_masks_equal(data):
    ds, preds, _, rpreds, _ = data
    idx, ref = AttributeIndex.build(ds.cat, ds.num), RefIndex.build(ds.cat, ds.num)
    cache, rcache = PredicateCache(8, 4), RefCache(8, 4)
    for p, rp in zip(preds[:20] + preds[:5], rpreds[:20] + rpreds[:5]):
        np.testing.assert_array_equal(cache.mask(p, idx), rcache.mask(rp, ref))
    assert cache.stats() == rcache.stats()


def _estimators(ds, preds, rpreds, sels, with_index):
    st = DatasetStats.build(ds.vectors, ds.cat, ds.num, sample_frac=0.05, seed=0)
    rst = RefStats.build(ds.vectors, ds.cat, ds.num, sample_frac=0.05, seed=0)
    idx = AttributeIndex.build(ds.cat, ds.num) if with_index else None
    ridx = RefIndex.build(ds.cat, ds.num) if with_index else None
    est = SelectivityEstimator(st, index=idx, cache=PredicateCache() if with_index else None)
    ref = RefEstimator(rst, index=ridx, cache=RefCache() if with_index else None)
    est.fit(preds[:40], sels[:40])
    ref.fit(rpreds[:40], sels[:40])
    return est, ref


@pytest.mark.parametrize("with_index", [False, True])
def test_sel_estimates_equal(data, with_index):
    ds, preds, sels, rpreds, _ = data
    est, ref = _estimators(ds, preds, rpreds, sels, with_index)
    for p, rp in zip(preds, rpreds):
        a, b = est.estimate(p), ref.estimate(rp)
        assert (a.sel, a.is_exact) == (b.sel, b.is_exact)
        np.testing.assert_array_equal(est.features(p), ref.features(rp))
    batch = est.estimate_batch(preds)
    rbatch = ref.estimate_batch(rpreds)
    assert [(s.sel, s.is_exact) for s in batch] == [(s.sel, s.is_exact) for s in rbatch]
    if with_index:
        assert all(s.is_exact for s in batch)
        assert [s.sel for s in batch] == [p.selectivity(ds.cat, ds.num) for p in preds]


def test_gbm_predictions_equal_and_carry():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 9))
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1] ** 2 + rng.normal(0, 0.05, 300)
    g, r = GradientBoostingRegressor().fit(x, y), RefGBM().fit(x, y)
    xt = rng.normal(size=(50, 9))
    np.testing.assert_array_equal(g.predict(xt), r.predict(xt))
    carried = carry.gbm_from_state(carry.gbm_state(r))
    np.testing.assert_array_equal(carried.predict(xt), r.predict(xt))
    assert len(carried.trees_) == len(r.trees_)


# -- range words: the cumulative edge layout against the bucket OR and the scan --

INF = math.inf


def _edges(n, buckets):
    """The index's equi-depth edges, in sorted positions."""
    b = max(1, min(buckets, n))
    return [int(x) for x in np.round(np.linspace(0, n, b + 1))]


def _distinct(n):
    """A column of distinct float32 values, so a bound sits at one position."""
    return np.random.default_rng(n).permutation(n).astype(np.float32) * 0.25 + 3.0


def _bound(sv, p):
    """A bound whose cut lands on sorted position ``p`` (n is +inf)."""
    return float(sv[p]) if p < sv.size else INF


def _at(sv, positions):
    return [(_bound(sv, p), _bound(sv, q)) for p, q in positions if p < q]


def _on_edge(buckets):
    col = _distinct(2085)
    sv, e = np.sort(col), _edges(col.size, buckets)
    b, mid = len(e) - 1, e[(len(e) - 1) // 2]
    pos = [(e[j], e[k]) for j in (0, 1, b // 2) for k in (j + 1, b) if k <= b]
    pos += [(e[1], e[1] + 1), (max(e[1] - 1, 0), e[b - 1]), (mid, mid + 2), (max(mid - 3, 0), mid)]
    return col, _at(sv, pos)


def _one_edge(buckets):
    col = _distinct(2085)
    sv, e = np.sort(col), _edges(col.size, buckets)
    b, n = len(e) - 1, col.size
    h = max(1, min(np.diff(e)) // 2 - 1)       # short of half the smallest bucket
    pos = [(max(0, e[j] - d0), min(n, e[j] + d1))
           for j in sorted({0, 1, b // 2, b - 1, b}) for d0, d1 in ((1, 1), (h, 1), (1, h), (h, h))]
    return col, _at(sv, pos)


def _first_last(buckets):
    col = _distinct(1000)
    sv, e = np.sort(col), _edges(col.size, buckets)
    b, n = len(e) - 1, col.size
    pos = [(0, e[1]), (e[b - 1], n), (0, n), (1, n - 1), (0, 1), (n - 1, n), (1, e[1] + 1)]
    return col, _at(sv, pos) + [(-INF, _bound(sv, e[1])), (_bound(sv, e[b - 1]), INF), (-INF, INF)]


def _small_n(buckets):
    out = []
    for n in (20, 45):                         # fewer rows than 64 buckets; a part word
        col = _distinct(n)
        out.append((col, _at(np.sort(col), [(p, q) for p in range(0, n, 3)
                                             for q in range(p + 1, n + 1, 4)])))
    return out


def _empty(buckets):
    return np.zeros(0, np.float32), [(0.0, 1.0), (-INF, INF)]


def _inf_and_rounding(buckets):
    col = (np.random.default_rng(3).normal(size=1013) * 1e3).astype(np.float32)
    sv, e = np.sort(col), _edges(col.size, buckets)
    iv = [(-INF, INF), (-INF, float(sv[500])), (float(sv[500]), INF), (-1e39, 1e39),
          (1e39, INF), (-INF, -1e39)]
    for p in sorted({min(e[1], col.size - 1), e[(len(e) - 1) // 2], 37, 800}):
        v = float(sv[p])
        below, above = float(np.nextafter(v, -INF)), float(np.nextafter(v, INF))
        # Python floats that round to the float32 value: each cut lands on it
        iv += [(v * (1 + 2 ** -30), INF), (below, INF), (-INF, v * (1 - 2 ** -30)),
               (-INF, above), (below, above)]
    return col, iv


def _equal_runs(buckets):
    # few distinct values: runs of equal values straddle every edge
    col = np.random.default_rng(5).integers(0, 9, 1507).astype(np.float32)
    return col, ([(float(a), float(a + w)) for a in range(-1, 10) for w in (1, 3, 11)]
                 + [(a + 0.5, a + 2.0) for a in range(-1, 9)])


RANGE_CASES = {"on_edge": _on_edge, "one_edge": _one_edge, "first_last": _first_last,
               "small_n": _small_n, "empty": _empty, "inf_and_rounding": _inf_and_rounding,
               "equal_runs": _equal_runs}


@pytest.mark.parametrize("buckets", [1, 7, 64, 128])
@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_range_words_equal_the_scan_and_the_reference(case, buckets):
    made = RANGE_CASES[case](buckets)
    for col, intervals in (made if isinstance(made, list) else [made]):
        num = np.stack([col, -col], 1)         # a second attribute, read in reverse
        idx, ref = RangeIndex.build(num, buckets), RefRangeIndex.build(num, buckets)
        for attr in (0, 1):
            x = num[:, attr]
            ivs = intervals if attr == 0 else [(-hi, -lo) for lo, hi in intervals]
            scans = []
            for lo, hi in ivs:
                with np.errstate(over="ignore"):
                    scans.append(pack_mask((x >= lo) & (x < hi)))   # the scan's dtype
                got = idx.interval_words(attr, lo, hi)
                np.testing.assert_array_equal(got, scans[-1], err_msg=f"[{lo}, {hi})")
                np.testing.assert_array_equal(got, ref.interval_words(attr, lo, hi))
            union = idx.union_words(attr, ivs)
            want = np.bitwise_or.reduce(scans) if scans else pack_mask(np.zeros(col.size, bool))
            np.testing.assert_array_equal(union, want)
            np.testing.assert_array_equal(union, ref.union_words(attr, ivs))
