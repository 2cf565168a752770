"""The port's numpy layer against the JAX package's, on the same arrays.

Bitmap words, popcount selectivity, ``SelEstimate`` and GBM predictions
must be bit-equal: the port's copies of these modules are numpy code with
only their imports re-pointed.
"""
import numpy as np
import pytest

from repro.core import trainer as ref_trainer
from repro.core.gbm import GradientBoostingRegressor as RefGBM
from repro.core.selectivity import SelectivityEstimator as RefEstimator
from repro.core.stats import DatasetStats as RefStats
from repro.filter import AttributeIndex as RefIndex
from repro.filter import PredicateCache as RefCache
from repro.filter import canonical_key as ref_key
from repro_torch import carry
from repro_torch.core import trainer
from repro_torch.core.gbm import GradientBoostingRegressor
from repro_torch.core.selectivity import SelectivityEstimator
from repro_torch.core.stats import DatasetStats
from repro_torch.data import make_dataset
from repro_torch.filter import AttributeIndex, PredicateCache, canonical_key


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
