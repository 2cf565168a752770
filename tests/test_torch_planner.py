"""The port's planner against the JAX package's.

The weights cannot come from the same init (``jax.random`` vs a torch
generator), so one state dict made from seeded numpy weights loads into
both: ``predict_proba`` agrees within 1e-6, ``decide`` and ``route`` are
equal.  The port's own ``fit`` must learn, and round-trip through
``state_dict``/``load_state``.
"""
import numpy as np
import pytest

from repro.core.planner import CorePlanner as RefPlanner
from repro.core.planner import PlannerFeatures as RefFeatures
from repro.core.planner import roc_auc as ref_roc_auc
from repro.core.stats import DatasetStats as RefStats
from repro_torch import carry
from repro_torch.core.planner import (
    INDEXED_PRE, POST_FILTER, PRE_FILTER, CorePlanner, PlannerFeatures, roc_auc,
)
from repro_torch.core.stats import DatasetStats
from repro_torch.core.trainer import gen_queries
from repro_torch.data import make_dataset

F = PlannerFeatures.N_FEATURES


def _seeded_state(seed=4, with_route=True):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (F - 1, 64), "b1": (64,), "w2": (64, 32), "b2": (32,),
              "w3": (32, 2), "b3": (2,)}
    # glorot-scale weights and small biases: a head that splits the rows
    params = {k: (rng.normal(0, np.sqrt(2.0 / sum(s)) if k[0] == "w" else 0.05, s))
              .astype(np.float32) for k, s in shapes.items()}
    state = {
        "params": params,
        "mu": rng.normal(0, 1, F - 1).astype(np.float32),
        "sigma": rng.uniform(0.5, 2.0, F - 1).astype(np.float32),
        "meta": np.asarray([F, 0], np.int32),
    }
    if with_route:
        names = ["ivf:nprobe8", "ivf:nprobe32", "acorn:ef64"]
        enc = np.zeros((3, 16), np.uint8)
        for i, n in enumerate(names):
            enc[i, : len(n)] = np.frombuffer(n.encode(), np.uint8)
        state["route"] = {"w": rng.normal(0, 1, (F, 3)).astype(np.float32),
                          "b": rng.normal(0, 1, 3).astype(np.float32),
                          "mu": rng.normal(0, 1, F).astype(np.float32),
                          "sigma": rng.uniform(0.5, 2, F).astype(np.float32),
                          "classes": enc}
    return state


def _features(seed=1, n=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, F)).astype(np.float32)
    x[:, PlannerFeatures.SEL_EXACT_COL] = rng.random(n) < 0.5
    return x


@pytest.mark.parametrize("with_route", [False, True])
def test_carried_state_predicts_like_reference(with_route):
    state = _seeded_state(with_route=with_route)
    port = carry.planner_from_state(state, device="cpu")
    ref = RefPlanner(n_features=F, seed=0).load_state(state)
    x = _features()
    np.testing.assert_allclose(port.predict_proba(x), np.asarray(ref.predict_proba(x)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.decide(x), ref.decide(x))
    assert set(port.decide(x)) == {PRE_FILTER, POST_FILTER, INDEXED_PRE}
    if with_route:
        np.testing.assert_array_equal(port.route(x), ref.route(x))
        assert port.route_classes == ref.route_classes
    else:
        assert port.route(x) is None and ref.route(x) is None
    # and back: the port's state loads into the reference unchanged
    ref2 = RefPlanner(n_features=F, seed=0).load_state(port.state_dict())
    np.testing.assert_allclose(np.asarray(ref2.predict_proba(x)), port.predict_proba(x),
                               rtol=0, atol=1e-6)


def test_features_equal_reference():
    ds = make_dataset("arxiv", "2000", seed=0)
    _, preds, sels = gen_queries(ds.vectors, ds.cat, ds.num, 20, kinds=ds.filter_kinds, seed=3)
    st = DatasetStats.build(ds.vectors, ds.cat, ds.num, sample_frac=0.05, seed=0)
    rst = RefStats.build(ds.vectors, ds.cat, ds.num, sample_frac=0.05, seed=0)
    exact = np.arange(20) % 2 == 0
    fm = PlannerFeatures(st).matrix(preds, sels, 10, exact)
    # the reference reads only .kind from each predicate: the port's serve
    np.testing.assert_array_equal(fm, RefFeatures(rst).matrix(preds, sels, 10, exact))
    np.testing.assert_array_equal(fm[3], PlannerFeatures(st).vector(preds[3], sels[3], 10, bool(exact[3])))


def test_roc_auc_equal_reference():
    rng = np.random.default_rng(2)
    y, s = rng.integers(0, 2, 500), rng.random(500).round(2)
    assert roc_auc(y, s) == ref_roc_auc(y, s)


def test_fit_learns_and_roundtrips():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (400, F)).astype(np.float32)
    x[:, PlannerFeatures.SEL_EXACT_COL] = 0.0
    y = ((x[:, 3] + 0.3 * x[:, 0]) > 0).astype(np.int32)
    p = CorePlanner(seed=0, device="cpu").fit(x, y)
    assert (p.decide(x) == y).mean() > 0.9
    assert p.val_auc_ > 0.9 and p.best_l2_ in (1e-4, 1e-3)
    q = CorePlanner(seed=5, device="cpu").load_state(p.state_dict())
    np.testing.assert_array_equal(q.predict_proba(x), p.predict_proba(x))
    assert q.generation == 1 and p.generation == 1


def test_fit_is_deterministic():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (120, F)).astype(np.float32)
    y = (x[:, 3] > 0).astype(np.int32)
    a = CorePlanner(seed=3, device="cpu").fit(x, y).predict_proba(x)
    b = CorePlanner(seed=3, device="cpu").fit(x, y).predict_proba(x)
    np.testing.assert_array_equal(a, b)


def test_routing_head_equal_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (200, F)).astype(np.float32)
    y = np.argmax(x[:, :3], axis=1)
    y[::17] = -1
    names = ("a:1", "b:2", "c:3")
    port = CorePlanner(device="cpu").fit_routing(x, y, names)
    ref = RefPlanner().fit_routing(x, y, names)
    np.testing.assert_array_equal(port.route(x), ref.route(x))
    for k in ("w", "b", "mu", "sigma"):
        np.testing.assert_array_equal(port._route[k], ref._route[k])
