"""The port's engine against the JAX package's, as a whole, on the CPU.

One 4000-row arxiv fixture per module; both engines get the same arrays.
The port receives the reference's learned and built state through
``repro_torch.carry``: its IVF layout (centroids + assignment), its
estimator GBM, and one planner head (a hand-set threshold on the
selectivity feature, loaded into the reference and read back from it).
The reference ``fit`` is not run: its labels are wall-clock races.

Over 40 ``gen_queries`` queries, equal between the two engines:
selectivity estimates, decisions, and result ids of every plan (up to
exact distance ties), from ``query`` and from ``batch_query``.
"""
import numpy as np
import pytest

from repro.core import EngineConfig as RefConfig
from repro.core import FilteredANNEngine as RefEngine
from repro.core import trainer as ref_trainer
from repro_torch import carry
from repro_torch.core import EngineConfig, FilteredANNEngine, gen_queries
from repro_torch.core.planner import PlannerFeatures
from repro_torch.data import make_dataset

K = 10
N_TRAIN, N_SERVE = 20, 40
TOL = dict(rtol=2e-4, atol=2e-4)


def _threshold_head(sel_cut: float) -> dict:
    """Planner state whose head says post iff est_sel > sel_cut."""
    f = PlannerFeatures.N_FEATURES - 1
    p = {"w1": np.zeros((f, 64), np.float32), "b1": np.zeros(64, np.float32),
         "w2": np.zeros((64, 32), np.float32), "b2": np.zeros(32, np.float32),
         "w3": np.zeros((32, 2), np.float32), "b3": np.zeros(2, np.float32)}
    p["w1"][PlannerFeatures.SEL_COL, 0] = 1.0
    p["w2"][0, 0] = 1.0
    p["w3"][0, 1] = 1.0
    p["b3"][0] = 1.0
    mu, sigma = np.zeros(f, np.float32), np.ones(f, np.float32)
    mu[PlannerFeatures.SEL_COL], sigma[PlannerFeatures.SEL_COL] = sel_cut - 0.01, 0.01
    return {"params": p, "mu": mu, "sigma": sigma,
            "meta": np.asarray([PlannerFeatures.N_FEATURES, 0], np.int32)}


@pytest.fixture(scope="module")
def engines():
    ds = make_dataset("arxiv", "4000", seed=0)
    n = N_TRAIN + N_SERVE
    q, preds, sels = gen_queries(ds.vectors, ds.cat, ds.num, n, kinds=ds.filter_kinds, seed=1)
    _, rpreds, _ = ref_trainer.gen_queries(ds.vectors, ds.cat, ds.num, n,
                                           kinds=ds.filter_kinds, seed=1)
    ref = RefEngine(ds.vectors, ds.cat, ds.num, RefConfig(seed=0)).build()
    ref.estimator.fit(rpreds[:N_TRAIN], sels[:N_TRAIN])
    ref.planner.load_state(_threshold_head(0.0301))
    ref.plan_cache.clear()
    port = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                             EngineConfig(seed=0, device="cpu")).build()
    ivf = ref.ivf
    assign = np.empty(ivf.n, np.int64)
    for lst in range(ivf.n_lists):
        assign[ivf.sorted_ids[ivf.offsets[lst]:ivf.offsets[lst + 1]]] = lst
    carry.install(port, centroids=ivf.centroids, assignment=assign,
                  gbm=carry.gbm_state(ref.estimator.model),
                  planner=ref.planner.state_dict())
    serve = slice(N_TRAIN, n)
    return ds, port, ref, q[serve], preds[serve], rpreds[serve]


def _same_up_to_ties(ids_a, d_a, ids_b, d_b):
    """Ids equal, except where the two answers differ only among ids at
    the same distance (an exact tie)."""
    np.testing.assert_allclose(d_a, d_b, **TOL)
    for r in range(ids_a.shape[0]):
        if np.array_equal(ids_a[r], ids_b[r]):
            continue
        for da, ia, ib in zip(d_a[r], ids_a[r], ids_b[r]):
            if ia != ib:
                assert np.sum(d_a[r] == da) > 1, f"row {r}: {ids_a[r]} vs {ids_b[r]}"


def test_estimates_and_decisions_equal(engines):
    _, port, ref, _, preds, rpreds = engines
    plans = [port.make_plan(p, K)[0] for p in preds]
    rplans = [ref.make_plan(p, K)[0] for p in rpreds]
    assert [p.est for p in plans] == [p.est for p in rplans]
    assert [p.sel_exact for p in plans] == [p.sel_exact for p in rplans]
    assert [p.decision for p in plans] == [p.decision for p in rplans]
    assert {p.strategy for p in plans} == {"ipre", "post"}
    bplans, _ = port.make_plan_batch(preds, K)
    assert [p.decision for p in bplans] == [p.decision for p in plans]
    assert port.explain(preds[0], K) == ref.explain(rpreds[0], K)


def test_query_ids_equal_reference(engines):
    _, port, ref, q, preds, rpreds = engines
    seen = set()
    for i in range(len(preds)):
        r = port.query(q[i], preds[i], K)
        rr = ref.query(q[i], rpreds[i], K)
        assert r.plan.strategy == rr.plan.strategy
        seen.add(r.plan.strategy)
        _same_up_to_ties(r.result.ids, r.result.dists, rr.result.ids, rr.result.dists)
        assert r.result.n_expansions == rr.result.n_expansions
    assert seen == {"ipre", "post"}


@pytest.mark.parametrize("exec_name", ["pre_exec", "ipre_exec", "post_exec"])
def test_every_executor_equals_reference(engines, exec_name):
    _, port, ref, q, preds, rpreds = engines
    ex, rex = getattr(port, exec_name), getattr(ref, exec_name)
    for i in range(0, len(preds), 4):
        kw = {"est_selectivity": 0.05} if exec_name == "post_exec" else {}
        a = ex.search(q[i:i + 1], preds[i], K, **kw)
        b = rex.search(q[i:i + 1], rpreds[i], K, **kw)
        _same_up_to_ties(a.ids, a.dists, b.ids, b.dists)


def test_batch_query_equals_query_and_reference(engines):
    _, port, ref, q, preds, rpreds = engines
    batch = port.batch_query(q, preds, K)
    rbatch = ref.batch_query(q, rpreds, K)
    for i, (b, rb) in enumerate(zip(batch, rbatch)):
        assert b.plan.decision == rb.plan.decision
        _same_up_to_ties(b.result.ids, b.result.dists, rb.result.ids, rb.result.dists)
        single = port.query(q[i], preds[i], K)
        np.testing.assert_array_equal(b.result.ids, single.result.ids)
        np.testing.assert_array_equal(b.result.dists, single.result.dists)


def test_ground_truth_equals_reference(engines):
    _, port, ref, q, preds, rpreds = engines
    for i in range(0, len(preds), 3):
        np.testing.assert_array_equal(port.ground_truth(q[i], preds[i], K),
                                      ref.ground_truth(q[i], rpreds[i], K))


def test_exact_plans_equal_ground_truth(engines):
    _, port, _, q, preds, _ = engines
    for i in range(len(preds)):
        r = port.query(q[i], preds[i], K)
        if r.plan.strategy in ("pre", "ipre"):
            np.testing.assert_array_equal(r.result.ids, port.ground_truth(q[i], preds[i], K))


def test_label_query_and_fit_run(engines):
    ds, _, _, q, preds, _ = engines
    eng = FilteredANNEngine(ds.vectors, ds.cat, ds.num, EngineConfig(seed=0, device="cpu")).build()
    lab = eng.label_query(q[0], preds[0], K)
    assert lab.label in (0, 1) and lab.true_sel == preds[0].selectivity(ds.cat, ds.num)
    eng.fit(q[:8], preds[:8], K)
    assert eng.planner.params is not None and eng.estimator.model is not None
    assert eng.query(q[9], preds[9], K).result.ids.shape == (1, K)


def test_outside_the_slice_raises(engines):
    """Only the live-corpus mutations are outside the port so far; ``Or``
    predicates and ``EngineConfig.backends`` are held to the reference in
    tests/test_torch_plan_dnf.py and tests/test_torch_backends.py."""
    ds, port, _, q, preds, _ = engines
    with pytest.raises(NotImplementedError):
        port.upsert(ds.vectors[:1], ds.cat[:1], ds.num[:1])
    with pytest.raises(NotImplementedError):
        port.delete(np.arange(3))
    with pytest.raises(NotImplementedError):
        port.compact()


def test_post_recall_equals_reference_at_reduced_scale():
    """Both packages' post-filter executors at arxiv "reduced" scale
    (120,000 rows) over the reference's IVF layout, 32 gen_queries queries
    at their true selectivity: the same ids per row apart from exact ties,
    so the same recall@10 against exact ground truth (printed with -s)."""
    import torch

    from repro.core.executors import PostFilterExec as RefPost
    from repro.index.ivf import IVFIndex as RefIVF
    from repro_torch.core.executors import PostFilterExec, recall_at_k
    from repro_torch.index.flat import l2_topk

    ds = make_dataset("arxiv", "reduced", seed=0)
    assert ds.vectors.shape == (120_000, 384)
    n = 32
    q, preds, sels = gen_queries(ds.vectors, ds.cat, ds.num, n, kinds=ds.filter_kinds, seed=2)
    _, rpreds, _ = ref_trainer.gen_queries(ds.vectors, ds.cat, ds.num, n,
                                           kinds=ds.filter_kinds, seed=2)
    rivf = RefIVF(ds.vectors, seed=0).build()
    ivf = carry.ivf_from_assignment(ds.vectors, rivf.centroids, carry.ivf_assignment(rivf),
                                    device="cpu")
    post, rpost = PostFilterExec(ivf, ds.cat, ds.num), RefPost(rivf, ds.cat, ds.num)
    x = torch.as_tensor(ds.vectors)
    rec, rrec = [], []
    for i in range(n):
        a = post.search(q[i:i + 1], preds[i], K, est_selectivity=float(sels[i]))
        b = rpost.search(q[i:i + 1], rpreds[i], K, est_selectivity=float(sels[i]))
        _same_up_to_ties(a.ids, a.dists, b.ids, b.dists)
        assert a.n_expansions == b.n_expansions
        m = torch.as_tensor(preds[i].eval(ds.cat, ds.num))
        _, ti = l2_topk(torch.as_tensor(q[i:i + 1]), x, K, m)
        rec.append(recall_at_k(a.ids, ti.numpy()))
        rrec.append(recall_at_k(b.ids, ti.numpy()))
    print(f"post recall@10 at 120,000 rows over {n} queries: port {np.mean(rec):.4f}, "
          f"reference {np.mean(rrec):.4f}")
    assert np.mean(rec) == np.mean(rrec)
