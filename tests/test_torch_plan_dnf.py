"""The port's per-disjunct DNF plans, against the JAX package's, on the CPU.

The flat cases of tests/test_plan_dnf.py, run on the port: conjunctions
plan as single-clause plans, ``Or`` plans per unique disjunct, permuted
``Or``s share a plan-cache entry, an all-exact union equals the
whole-predicate scan bit for bit (with cross-clause de-duplication), and a
mixed batch equals its queries one at a time.  Then both packages plan and
answer the same ``Or``s over the same arrays, and the two merges are held
to the reference's bit for bit.

The engines are built but not fitted: the untrained fallback
(est < 0.05 -> pre/ipre) is deterministic, so low-selectivity clauses plan
exact, which the bit-identity cases need.
"""
import numpy as np
import pytest

import repro.core as rc
import repro_torch.core as pc
from repro.core import EngineConfig as RefConfig
from repro.core import FilteredANNEngine as RefEngine
from repro.dist.collectives import merge_topk as ref_merge_topk
from repro.dist.collectives import merge_topk_unique as ref_merge_topk_unique
from repro_torch import carry
from repro_torch.core import (
    INDEXED_PRE,
    PRE_FILTER,
    EngineConfig,
    ExecutionPlan,
    FilteredANNEngine,
    LabelEq,
    Or,
    Predicate,
    RangePred,
    SelEstimate,
)
from repro_torch.data import make_dataset
from repro_torch.dist.collectives import merge_topk, merge_topk_unique
from test_torch_engine import _same_up_to_ties as _same_within_band

K = 10
EXACT = (PRE_FILTER, INDEXED_PRE)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def ds():
    return make_dataset("arxiv", "4000", seed=0)


@pytest.fixture(scope="module")
def eng(ds):
    return FilteredANNEngine(
        ds.vectors, ds.cat, ds.num, EngineConfig(n_lists=32, seed=0, device="cpu")
    ).build()


@pytest.fixture(scope="module")
def ref_eng(ds):
    return RefEngine(ds.vectors, ds.cat, ds.num, RefConfig(n_lists=32, seed=0)).build()


def _label_pairs(ds, want=3, lo=0.001, hi=0.04):
    """(a, b) label codes whose conjunction's exact selectivity lies in
    (lo, hi]: under the fallback planner these always plan exact."""
    out = []
    for a in np.unique(ds.cat[:, 0]):
        for b in np.unique(ds.cat[:, 1]):
            sel = np.mean((ds.cat[:, 0] == a) & (ds.cat[:, 1] == b))
            if lo < sel <= hi:
                out.append((int(a), int(b)))
                if len(out) == want:
                    return out
    raise RuntimeError("fixture corpus has no low-selectivity label pairs")


def _low_sel_conjunctions(ds, want=3, lo=0.001, hi=0.04):
    return [Predicate(labels=(LabelEq(0, a), LabelEq(1, b)))
            for a, b in _label_pairs(ds, want, lo, hi)]


def _midpoints(ds, n, seed):
    """Queries halfway between two corpus rows: no distance is near zero,
    where the expansion form cancels and two fp32 orders drift apart."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(ds.vectors.shape[0], size=(2, n))
    return ((ds.vectors[a] + ds.vectors[b]) / 2).astype(np.float32)


# ----------------------------------------------------------------------
# plan structure
# ----------------------------------------------------------------------
def test_conjunction_plans_single_clause(eng, ds):
    p = _low_sel_conjunctions(ds, want=1)[0]
    plan, _ = eng.make_plan(p, K)
    assert isinstance(plan, ExecutionPlan)
    assert plan.merge == "none" and not plan.is_dnf and plan.n_clauses == 1
    assert plan.strategy in ("pre", "post", "ipre")
    assert plan.decision == plan.clauses[0].decision


def test_or_plans_per_disjunct(eng, ds):
    a, b, c = _low_sel_conjunctions(ds, want=3)
    plan, _ = eng.make_plan(Or((a, b, c)), K)
    assert plan.is_dnf and plan.merge == "union" and plan.n_clauses == 3
    assert plan.strategy == "dnf" and plan.backend == "dnf"
    for cl in plan.clauses:
        assert cl.decision in EXACT and cl.sel_exact
    dup, _ = eng.make_plan(Or((a, b, a)), K)
    assert dup.n_clauses == 2
    solo, _ = eng.make_plan(Or((a,)), K)
    assert solo.is_dnf and solo.n_clauses == 1
    empty, _ = eng.make_plan(Or(()), K)
    assert empty.is_dnf and empty.n_clauses == 0
    r = eng.query(ds.vectors[0], Or(()), K)
    assert (r.result.ids == -1).all() and np.isinf(r.result.dists).all()


def test_permuted_or_shares_cache_entry(eng, ds):
    a, b, c = _low_sel_conjunctions(ds, want=3)
    eng.plan_cache.clear()
    p1, _ = eng.make_plan(Or((a, b, c)), K)
    h0 = eng.plan_cache.stats()["hits"]
    p2, _ = eng.make_plan(Or((c, a, b)), K)
    assert eng.plan_cache.stats()["hits"] == h0 + 1
    assert p1 is p2
    q = ds.vectors[0]
    r1 = eng.query(q, Or((a, b, c)), K)
    r2 = eng.query(q, Or((c, a, b)), K)
    np.testing.assert_array_equal(r1.result.ids, r2.result.ids)


# ----------------------------------------------------------------------
# exact-tier bit-identity and de-duplication
# ----------------------------------------------------------------------
def test_per_disjunct_bit_identical_flat(eng, ds):
    dnf = Or(tuple(_low_sel_conjunctions(ds, want=3)))
    plan, _ = eng.make_plan(dnf, K)
    assert all(cl.decision in EXACT for cl in plan.clauses)
    rng = np.random.default_rng(7)
    for _ in range(6):
        q = ds.vectors[rng.integers(ds.vectors.shape[0])]
        out = eng.query(q, dnf, K)
        ref = eng.pre_exec.search(q[None], dnf, K)   # whole-predicate mask
        np.testing.assert_array_equal(out.result.ids, ref.ids)
        np.testing.assert_array_equal(out.result.dists, ref.dists)
        np.testing.assert_array_equal(out.result.ids, eng.ground_truth(q, dnf, K))


def test_per_disjunct_bit_identical_live(ds, ref_eng):
    """A mutated corpus: upserted copies of 40 base rows land in the append
    segment, 25 base rows are tombstoned.  The per-disjunct union equals
    the live ground truth bit for bit, every copy ties its base row exactly
    and comes right after it, and the union equals the reference's live
    union up to ties (the reference's own live test trips over that tie:
    its two scans round a row and its copy differently)."""
    e = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                          EngineConfig(n_lists=32, seed=0, device="cpu")).build()
    r = RefEngine(ds.vectors, ds.cat, ds.num, RefConfig(n_lists=32, seed=0)).build()
    clauses = _low_sel_conjunctions(ds, want=2)
    dnf = Or(tuple(clauses))
    rdnf = rc.Or(tuple(rc.Predicate(labels=tuple(rc.LabelEq(t.attr, t.code) for t in c.labels))
                       for c in clauses))
    rng = np.random.default_rng(17)
    n = ds.vectors.shape[0]
    passing = np.flatnonzero(dnf.eval(ds.cat, ds.num) & (np.arange(n) >= 25))
    rows = rng.permutation(np.union1d(rng.choice(n, 36, replace=False),
                                      rng.choice(passing, 4, replace=False)))
    for eng_ in (e, r):
        eng_.upsert(ds.vectors[rows], ds.cat[rows], ds.num[rows])
        eng_.delete(np.arange(25))
    assert e.live.dirty
    copy_of = dict(zip(rows.tolist(), range(n, n + rows.size)))
    picks = [ds.vectors[i] for i in rng.integers(n, size=4)]
    picks += [ds.vectors[i] + 1e-3 for i in rows[np.isin(rows, passing)][:2]]
    for q in picks:
        q = np.asarray(q, np.float32)
        out = e.query(q, dnf, K)
        np.testing.assert_array_equal(out.result.ids, e.ground_truth(q, dnf, K))
        row = out.result.ids[0].tolist()
        for base, cp in copy_of.items():
            if base in row and cp in row:
                assert row.index(cp) == row.index(base) + 1
                assert out.result.dists[0, row.index(cp)] == out.result.dists[0, row.index(base)]
        ro = r.query(q, rdnf, K)
        _same_within_band(q, out.result.ids, out.result.dists, ro.result.ids, ro.result.dists)


def test_cross_clause_dedup(eng, ds):
    """One clause contains the other: each id surfaces once, and the union
    equals the whole-predicate scan."""
    wide = _low_sel_conjunctions(ds, want=1, lo=0.01, hi=0.04)[0]
    x1 = ds.num[:, 1]
    narrow = Predicate(
        labels=wide.labels,
        ranges=(RangePred(1, ((float(np.quantile(x1, 0.1)),
                               float(np.quantile(x1, 0.9))),)),),
    )
    dnf = Or((wide, narrow))
    plan, _ = eng.make_plan(dnf, K)
    assert plan.n_clauses == 2
    assert all(cl.decision in EXACT for cl in plan.clauses)
    rng = np.random.default_rng(11)
    for _ in range(6):
        q = ds.vectors[rng.integers(ds.vectors.shape[0])]
        out = eng.query(q, dnf, K)
        row = out.result.ids[0]
        valid = row[row >= 0]
        assert len(set(valid.tolist())) == len(valid), "duplicate id surfaced"
        ref = eng.pre_exec.search(q[None], dnf, K)
        np.testing.assert_array_equal(out.result.ids, ref.ids)
        np.testing.assert_array_equal(out.result.dists, ref.dists)
    r_dup = eng.query(ds.vectors[3], Or((wide, wide)), K)
    r_solo = eng.query(ds.vectors[3], wide, K)
    np.testing.assert_array_equal(r_dup.result.ids, r_solo.result.ids)
    np.testing.assert_array_equal(r_dup.result.dists, r_solo.result.dists)


def test_batch_mixed_dnf_matches_per_query(eng, ds):
    clauses = _low_sel_conjunctions(ds, want=3)
    dnf = Or(tuple(clauses))
    preds = [clauses[0], dnf, clauses[1], Or((clauses[1], clauses[2])), clauses[2]]
    rng = np.random.default_rng(19)
    qs = ds.vectors[rng.integers(ds.vectors.shape[0], size=len(preds))]
    batch = eng.batch_query(qs, preds, K)
    assert len(batch) == len(preds)
    for i, r in enumerate(batch):
        solo = eng.query(qs[i], preds[i], K)
        np.testing.assert_array_equal(r.result.ids, solo.result.ids)
        np.testing.assert_array_equal(r.result.dists, solo.result.dists)
        assert r.plan.strategy == solo.plan.strategy
    assert batch[1].plan.is_dnf and not batch[0].plan.is_dnf
    conj_batch = eng.batch_query(qs[:3], clauses, K)
    for i, r in enumerate(conj_batch):
        solo = eng.query(qs[i], clauses[i], K)
        np.testing.assert_array_equal(r.result.ids, solo.result.ids)


def test_sel_estimate_api(eng, ds):
    a, b, c = _low_sel_conjunctions(ds, want=3)
    se = eng.estimator.estimate(a)
    assert isinstance(se, SelEstimate)
    assert 0.0 <= se.sel <= 1.0 and se.is_exact and se.per_clause is None
    assert float(se) == se.sel
    orse = eng.estimator.estimate(Or((a, b, a, c)))
    assert len(orse.per_clause) == 4
    assert orse.per_clause[0].sel == orse.per_clause[2].sel == se.sel
    assert orse.sel == pytest.approx(Or((a, b, c)).selectivity(ds.cat, ds.num))
    ses = eng.estimator.estimate_batch([a, Or((a, b)), c])
    assert all(isinstance(s, SelEstimate) for s in ses)
    assert ses[0].sel == se.sel


def test_label_query_and_fit_decompose_ors(ds):
    """An ``Or``'s label carries one race per unique disjunct, and ``fit``
    trains on one row per unique disjunct."""
    e = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                          EngineConfig(n_lists=32, seed=0, device="cpu")).build()
    a, b = _low_sel_conjunctions(ds, want=2)
    lab = e.label_query(ds.vectors[0], Or((a, b, a)), K)
    assert lab.clauses is not None and len(lab.clauses) == 2
    assert all(cl.clauses is None for cl in lab.clauses)
    assert lab.clauses[0].true_sel == a.selectivity(ds.cat, ds.num)
    qs = _midpoints(ds, 6, seed=5)
    e.fit(qs, [a, b, Or((a, b, a)), Or((b,)), a, b], K)
    assert e.labels_.shape == (2 + 2 + 1 + 2,)
    assert e.planner.params is not None
    assert e.query(qs[0], Or((a, b)), K).result.ids.shape == (1, K)


# ----------------------------------------------------------------------
# the two packages on the same Ors
# ----------------------------------------------------------------------
def _same_up_to_ties(ids_a, d_a, ids_b, d_b):
    np.testing.assert_allclose(d_a, d_b, **TOL)
    for r in range(ids_a.shape[0]):
        for da, ia, ib in zip(d_a[r], ids_a[r], ids_b[r]):
            if ia != ib:
                assert np.sum(d_a[r] == da) > 1, f"row {r}: {ids_a[r]} vs {ids_b[r]}"


def test_dnf_plans_and_answers_equal_reference(ds, ref_eng):
    """Same arrays, same Ors: equal clause decisions and estimates, ids up
    to exact ties, distances within 2e-4, from query and batch_query.  The
    port carries the reference's IVF, so post clauses probe the same lists."""
    port = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                             EngineConfig(n_lists=32, seed=0, device="cpu")).build()
    ivf = ref_eng.ivf
    carry.install(port, centroids=ivf.centroids, assignment=carry.ivf_assignment(ivf))
    lows = _label_pairs(ds, want=3)
    codes, counts = np.unique(ds.cat[:, 0], return_counts=True)
    wide = [int(a) for a in codes[np.argsort(-counts, kind="stable")][:2]]   # post clauses
    assert np.mean(ds.cat[:, 0] == wide[1]) > 0.05

    def build(ns):
        lo = [ns.Predicate(labels=(ns.LabelEq(0, a), ns.LabelEq(1, b))) for a, b in lows]
        hi = [ns.Predicate(labels=(ns.LabelEq(0, a),)) for a in wide]
        return [ns.Or((lo[0], lo[1])), ns.Or((lo[2], lo[0], lo[1])), ns.Or((lo[0], hi[0])),
                ns.Or((hi[1], lo[1], hi[1])), ns.Or((hi[0], hi[1])), lo[2]]

    preds, rpreds = build(pc), build(rc)
    seen = set()
    for p, rp in zip(preds, rpreds):
        plan, _ = port.make_plan(p, K)
        rplan, _ = ref_eng.make_plan(rp, K)
        assert plan.merge == rplan.merge and plan.est == rplan.est
        assert [(c.decision, c.backend, c.knob, c.est, c.sel_exact) for c in plan.clauses] == \
            [(c.decision, c.backend, c.knob, c.est, c.sel_exact) for c in rplan.clauses]
        seen |= {c.decision for c in plan.clauses}
    assert seen == {INDEXED_PRE, rc.POST_FILTER}
    qs = _midpoints(ds, len(preds), seed=3)
    batch = port.batch_query(qs, preds, K)
    rbatch = ref_eng.batch_query(qs, rpreds, K)
    for i in range(len(preds)):
        r = port.query(qs[i], preds[i], K)
        rr = ref_eng.query(qs[i], rpreds[i], K)
        _same_up_to_ties(r.result.ids, r.result.dists, rr.result.ids, rr.result.dists)
        _same_up_to_ties(batch[i].result.ids, batch[i].result.dists,
                         rbatch[i].result.ids, rbatch[i].result.dists)
        np.testing.assert_array_equal(batch[i].result.ids, r.result.ids)
        assert r.result.n_expansions == rr.result.n_expansions
    assert port.explain(preds[1], K) == ref_eng.explain(rpreds[1], K)


@pytest.mark.parametrize("fn,ref_fn", [(merge_topk, ref_merge_topk),
                                       (merge_topk_unique, ref_merge_topk_unique)])
@pytest.mark.parametrize("lists,k_i,k", [(3, 10, 10), (4, 6, 10), (2, 3, 10), (1, 10, 4)])
def test_merges_equal_reference_bitwise(fn, ref_fn, lists, k_i, k):
    """Random lists with forced distance ties, repeated ids across lists
    and -1/inf padding: both merges equal the reference's bit for bit."""
    rng = np.random.default_rng(lists * 100 + k_i)
    b = 16
    d = np.round(rng.random((lists, b, k_i)) * 4, 1).astype(np.float32)   # many ties
    ids = rng.integers(0, 40, (lists, b, k_i)).astype(np.int32)           # repeats
    pad = rng.random((lists, b, k_i)) < 0.15
    d[pad], ids[pad] = np.inf, -1
    d = np.sort(d, axis=2)
    got_d, got_i = fn(d, ids, k)
    want_d, want_i = ref_fn(d, ids, k)
    assert got_d.dtype == want_d.dtype and got_i.dtype == want_i.dtype
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
