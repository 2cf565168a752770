"""The port's checkpointer (``repro_torch.ckpt``) against the JAX package's,
on the CPU.

The on-disk format is the reference's (``step_<N>/manifest.json`` plus one
``.npy`` per leaf), so a directory written by either package restores in
the other with the same keys and bitwise-equal values.  The port flattens
trees without jax and must give the keys and order
``jax.tree_util.tree_flatten_with_path`` gives; leaves are torch tensors
or numpy arrays, and ``restore(device=)`` takes the place of the
reference's ``shardings=``.  The planner's and the live corpus' states go
through it in both directions (the corpus from the 4,000-row arxiv
fixture, the same arrays in both packages).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import Checkpointer as RefCheckpointer
from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro.core import EngineConfig as RefConfig
from repro.core import FilteredANNEngine as RefEngine
from repro.core.planner import CorePlanner as RefPlanner
from repro_torch.ckpt import Checkpointer
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.core import EngineConfig, FilteredANNEngine
from repro_torch.core.planner import CorePlanner, PlannerFeatures
from repro_torch.data import make_dataset


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.as_tensor(rng.normal(0, 1, (8, 4)).astype(np.float32)),
        "nested": {"b": np.arange(10, dtype=np.int32),
                   "list": [np.float64(2.5), (np.ones(3, np.uint8), torch.zeros(2, 2))]},
        "10": np.asarray(7, np.int64),
        "2": None,
    }


def _leaves(tree):
    return [np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()
            for _, v in _flatten(tree)]


@pytest.fixture(scope="module")
def corpus():
    return make_dataset("arxiv", "4000", seed=0)


def test_flatten_keys_equal_jax(corpus):
    t = _tree()
    keys = [k for k, _ in _flatten(t)]
    assert keys == [k for k, _ in ref_flatten(jax.tree.map(np.asarray, t))]
    assert keys == ["10", "a", "nested/b", "nested/list/0", "nested/list/1/0",
                    "nested/list/1/1"]
    eng = FilteredANNEngine(corpus.vectors, corpus.cat, corpus.num,
                            EngineConfig(seed=0, device="cpu")).build_stats()
    state = {"t1": eng.mutation_state(), "t0": eng.mutation_state()}
    assert [k for k, _ in _flatten(state)] == [k for k, _ in ref_flatten(state)]


def test_round_trip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(3, t)
    out = ck.restore(3, t)
    assert isinstance(out["nested"]["list"], list) and isinstance(out["nested"]["list"][1], tuple)
    assert out["2"] is None
    for a, b in zip(_leaves(t), _leaves(out)):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_restore_onto_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(1, t)
    out = ck.restore(1, t, device="cpu")
    assert isinstance(out["a"], torch.Tensor) and out["a"].device.type == "cpu"
    assert out["nested"]["b"].dtype == torch.int32
    torch.testing.assert_close(out["a"], t["a"], rtol=0, atol=0)


def test_latest_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        ck.save(s, _tree(s), meta={"s": s})
    assert ck.latest_step() == 4
    assert ck.steps() == [3, 4]
    assert ck.read_meta(3) == {"s": 3} and ck.latest_meta() == {"s": 4}
    assert Checkpointer(str(tmp_path / "empty")).latest_meta() == {}


def test_async_save_snapshots_on_the_callers_thread(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    want = t["a"].clone()
    ck.save_async(7, t)
    t["a"].add_(1.0)                  # the snapshot was taken before this
    ck.save_async(8, _tree(1))         # waits for step 7's writer first
    ck.wait()
    assert ck.steps() == [7, 8]
    torch.testing.assert_close(torch.as_tensor(ck.restore(7, t)["a"]), want, rtol=0, atol=0)


def test_atomic_no_torn_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert ck.steps() == [1]
    ck.save(2, _tree(2))               # a stale .tmp is cleared, not reused
    assert ck.steps() == [1, 2]


def test_restore_missing_leaf_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="missing leaves"):
        ck.restore(1, {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_bf16_leaf_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(TypeError, match="bfloat16"):
        ck.save(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert ck.steps() == []


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directories_restore_across_packages(tmp_path, writer):
    t = _tree(3)
    host = jax.tree.map(np.asarray, {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                                     for k, v in t.items() if k != "nested"})
    host["nested"] = {"b": t["nested"]["b"],
                      "list": [np.asarray(t["nested"]["list"][0]),
                               [np.asarray(x) for x in t["nested"]["list"][1]]]}
    if writer == "reference":
        RefCheckpointer(str(tmp_path)).save(5, host, meta={"by": writer})
    else:
        Checkpointer(str(tmp_path)).save(5, t, meta={"by": writer})
    got = Checkpointer(str(tmp_path)).restore(5, t)
    rgot = RefCheckpointer(str(tmp_path)).restore(5, host)
    assert [k for k, _ in _flatten(got)] == [k for k, _ in ref_flatten(rgot)]
    for (_, a), (_, b), w in zip(_flatten(got), ref_flatten(rgot), _leaves(t)):
        b = np.asarray(b)
        assert a.dtype == w.dtype and a.tobytes() == w.tobytes()
        # jax keeps 32-bit types unless x64 is on: compare the values
        np.testing.assert_array_equal(a, b)
    for ck in (Checkpointer(str(tmp_path)), RefCheckpointer(str(tmp_path))):
        assert ck.latest_meta() == {"by": writer}


def test_planner_state_through_checkpointer(tmp_path):
    """A port planner's state (routing head and its encoded class names
    included) restores in both packages to the same predictions; a
    plan-only state restores to a plan-only planner."""
    f = PlannerFeatures.N_FEATURES
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (200, f)).astype(np.float32)
    y = (x[:, 3] > 0).astype(np.int32)
    classes = ("flat:exact", "ivf:fast", "ivfpq:precise")
    p = CorePlanner(n_features=f, seed=0, device="cpu").fit(x, y)
    legacy = p.state_dict()
    p.fit_routing(x, np.minimum(y * 2, 2), classes)
    routed = p.state_dict()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, legacy)
    ck.save(2, routed)
    q = CorePlanner(n_features=f, seed=7, device="cpu").load_state(ck.restore(2, routed))
    assert q.route_classes == classes
    np.testing.assert_array_equal(q.route(x), p.route(x))
    np.testing.assert_allclose(q.predict_proba(x), p.predict_proba(x), atol=1e-6)
    r = CorePlanner(n_features=f, seed=7, device="cpu").load_state(ck.restore(1, legacy))
    assert r.route_classes is None and r.route(x) is None
    rq = RefPlanner(n_features=f, seed=7).load_state(
        RefCheckpointer(str(tmp_path)).restore(2, jax.tree.map(np.asarray, routed)))
    assert rq.route_classes == classes
    np.testing.assert_array_equal(rq.route(x), p.route(x))
    np.testing.assert_allclose(rq.predict_proba(x), p.predict_proba(x), atol=1e-5)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mutation_state_through_checkpointer(tmp_path, corpus, writer):
    """A live corpus snapshot written by either package restores onto a
    clean engine of the other: the same live rows and exact answers."""
    ds = corpus
    port = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                             EngineConfig(seed=0, device="cpu")).build()
    ref = RefEngine(ds.vectors, ds.cat, ds.num, RefConfig(seed=0)).build()
    for eng in (port, ref):
        h = eng.upsert(ds.vectors[:6] + 0.01, ds.cat[:6], ds.num[:6])
        eng.delete(np.asarray([3, 9, int(h[1])]))
    src = port if writer == "port" else ref
    (Checkpointer if writer == "port" else RefCheckpointer)(str(tmp_path)).save(
        2, src.mutation_state(), meta={"generation": int(src.corpus_generation)})
    fresh = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                              EngineConfig(seed=0, device="cpu")).build()
    rfresh = RefEngine(ds.vectors, ds.cat, ds.num, RefConfig(seed=0)).build()
    fresh.load_mutation_state(Checkpointer(str(tmp_path)).restore(2, fresh.mutation_state()))
    rfresh.load_mutation_state({k: np.asarray(v) for k, v in RefCheckpointer(
        str(tmp_path)).restore(2, rfresh.mutation_state()).items()})
    for e in (fresh, rfresh):
        assert (e.live.n_total, e.live.live_count) == (port.live.n_total, port.live.live_count)
        np.testing.assert_array_equal(e.live.alive_mask(), port.live.alive_mask())
    from repro_torch.core import gen_queries

    qs, preds, _ = gen_queries(ds.vectors, ds.cat, ds.num, 6, kinds=ds.filter_kinds, seed=3)
    for q, p in zip(qs, preds):
        np.testing.assert_array_equal(fresh.ground_truth(q, p, 10), port.ground_truth(q, p, 10))
