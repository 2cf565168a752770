"""The port's live corpus (upsert, delete, compact) against the JAX
package's, on the CPU.

The cases of tests/test_mutation.py, run on both packages over the same
arrays and the same mutation sequence: every served id, ground truth and
``id_map`` of the port is held to the reference's (ids equal up to ties,
distances within ``test_torch_engine.distance_band``), and
the port's own invariants are held bit for bit: exact plans equal ground
truth, and after ``compact()`` they equal a fresh build over the compacted
corpus.  Both engines run their untrained planners (est < 0.05 -> exact),
which are deterministic; the port's IVF is the reference's, carried.

Beyond the reference's cases: a ``mutation_state`` round trip between the
two packages, an exact copy of a live base row (the base row must come
first, before and after compaction: the tie the reference's live DNF test
trips over), and the plan-epoch invalidations.  ``Or`` predicates and
``EngineConfig.backends`` over a live corpus are held to the reference in
tests/test_torch_plan_dnf.py and tests/test_torch_backends.py, and the
sharded path in tests/test_torch_dist_serve.py.
"""
import numpy as np
import pytest

import repro.core as rc
import repro_torch.core as pc
from repro.core import EngineConfig as RefConfig
from repro.core import FilteredANNEngine as RefEngine
from repro.dist.collectives import merge_topk as ref_merge_topk
from repro.serve.engine import ShardedANNEngine as RefSharded
from repro_torch import carry
from repro_torch.core import (
    CompactionPolicy,
    EngineConfig,
    FilteredANNEngine,
    LabelEq,
    LiveCorpus,
    Predicate,
    RangePred,
)
from repro_torch.dist.collectives import merge_topk
from repro_torch.serve import ShardedANNEngine
from test_torch_engine import _same_up_to_ties

K = 10
EXACT = ("pre", "ipre")


def _make_corpus(n=2500, d=16, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    cat = rng.integers(0, 5, (n, 2)).astype(np.int32)
    num = rng.standard_normal((n, 2)).astype(np.float32)
    return v, cat, num


@pytest.fixture(scope="module")
def corpus():
    return _make_corpus()


def _build(v, cat, num, **cfg):
    return FilteredANNEngine(v, cat, num, EngineConfig(seed=0, device="cpu", **cfg)).build()


def _pair(v, cat, num, **cfg):
    """(port, reference) engines over the same arrays, the port on the
    reference's IVF layout."""
    ref = RefEngine(v, cat, num, RefConfig(seed=0, **cfg)).build()
    port = _build(v, cat, num, **cfg)
    carry.install(port, centroids=ref.ivf.centroids, assignment=carry.ivf_assignment(ref.ivf))
    return port, ref


def _preds(p):
    """The reference's three predicates in package ``p``'s classes."""
    return (p.Predicate(labels=(p.LabelEq(0, 2), p.LabelEq(1, 3))),
            p.Predicate(labels=(p.LabelEq(0, 1),)),
            p.Predicate(ranges=(p.RangePred(0, ((-0.5, 0.5),)),)))


PRED, PRED_LABEL, PRED_RANGE = _preds(pc)
RPRED, RPRED_LABEL, RPRED_RANGE = _preds(rc)


def _mutate(eng, v, cat, seed=3):
    """The reference's churn burst: delete matching + random rows, upsert a
    few rows matching PRED (two of them copies of existing vectors)."""
    rng = np.random.default_rng(seed)
    match = np.nonzero((cat[:, 0] == 2) & (cat[:, 1] == 3))[0][:15]
    rand = rng.choice(len(v), 40, replace=False)
    eng.delete(np.concatenate([match, rand]))
    nv = np.concatenate([v[:2], rng.standard_normal((4, v.shape[1])).astype(np.float32)])
    nc = np.tile(np.array([[2, 3]], np.int32), (6, 1))
    nm = np.zeros((6, 2), np.float32)
    return eng.upsert(nv, nc, nm)


def _held_to(q, port_res, ref_res):
    """Two lists of served results agree row by row: plan, ids up to ties,
    distances within the band, expansion rounds."""
    for i, (a, b) in enumerate(zip(port_res, ref_res)):
        assert a.plan.strategy == b.plan.strategy, i
        _same_up_to_ties(q[i], a.result.ids, a.result.dists, b.result.ids, b.result.dists)
        assert a.result.n_expansions == b.result.n_expansions, i


# ----------------------------------------------------------------------
# post-mutation equivalence
# ----------------------------------------------------------------------
def test_exact_plan_bit_equality_vs_fresh_build(corpus):
    """Mutated engine == fresh build over the post-mutation corpus for
    exact plans: ground truth and the served exact ids translate bit for
    bit through the id_map; both equal the reference's."""
    v, cat, num = corpus
    eng, ref = _pair(v, cat, num)
    handles = _mutate(eng, v, cat)
    np.testing.assert_array_equal(handles, _mutate(ref, v, cat))
    q = v[:8]
    gt_live = eng.ground_truth(q, PRED, k=K)
    res = eng.batch_query(q, [PRED] * len(q), k=K)
    rres = ref.batch_query(q, [RPRED] * len(q), k=K)
    _held_to(q, res, rres)
    for i, pr in enumerate(res):
        assert pr.result.strategy in EXACT
        np.testing.assert_array_equal(pr.result.ids[0], gt_live[i])
        np.testing.assert_array_equal(eng.query(q[i], PRED, K).result.ids, pr.result.ids)
    np.testing.assert_array_equal(gt_live, ref.ground_truth(q, RPRED, k=K))

    cv, cc, cm, id_map = eng.live.compacted()
    rcv, _, _, rid_map = ref.live.compacted()
    np.testing.assert_array_equal(id_map, rid_map)
    np.testing.assert_array_equal(cv, rcv)
    fresh = _build(cv, cc, cm)
    tr = np.where(gt_live >= 0, id_map[np.maximum(gt_live, 0)], -1)
    np.testing.assert_array_equal(tr, fresh.ground_truth(q, PRED, k=K))
    fres = fresh.batch_query(q, [PRED] * len(q), k=K)
    for i, pr in enumerate(res):
        np.testing.assert_array_equal(
            np.where(pr.result.ids >= 0, id_map[np.maximum(pr.result.ids, 0)], -1),
            fres[i].result.ids)
        np.testing.assert_array_equal(pr.result.dists, fres[i].result.dists)
    assert (id_map[handles] >= 0).all()


def test_compact_preserves_results_and_restores_planner(corpus):
    v, cat, num = corpus
    eng, ref = _pair(v, cat, num)
    _mutate(eng, v, cat)
    _mutate(ref, v, cat)
    q = v[:6]
    gt_before = eng.ground_truth(q, PRED, k=K)
    gen_before = eng.corpus_generation
    assert gen_before == ref.corpus_generation
    version, planner = eng.planner_version, eng.planner
    id_map = eng.compact()
    np.testing.assert_array_equal(id_map, ref.compact())
    assert eng.n_compactions == 1 and eng.corpus_generation == gen_before + 1
    assert eng.planner is planner and eng.planner_version == version + 1
    assert not eng.live.dirty and eng.live.base_n == ref.live.base_n
    gt_after = eng.ground_truth(q, PRED, k=K)
    tr = np.where(gt_before >= 0, id_map[np.maximum(gt_before, 0)], -1)
    np.testing.assert_array_equal(tr, gt_after)
    np.testing.assert_array_equal(gt_after, ref.ground_truth(q, RPRED, k=K))
    r = eng.query(q[0], PRED, k=K)
    assert r.result.ids.shape == (1, K) and (r.result.ids >= 0).all()
    assert "compaction" in eng.build_time_


def test_delete_excludes_tombstones_every_plan(corpus):
    """No strategy may surface a deleted id; every row equals the
    reference's."""
    v, cat, num = corpus
    eng, ref = _pair(v, cat, num)
    match = np.nonzero(cat[:, 0] == 2)[0][:60]
    eng.delete(match)
    ref.delete(match)
    dead = set(match.tolist())
    seen = set()
    for pred, rpred in ((PRED, RPRED), (PRED_LABEL, RPRED_LABEL),
                        (Predicate(labels=(LabelEq(0, 2),)),
                         rc.Predicate(labels=(rc.LabelEq(0, 2),)))):
        res = eng.batch_query(v[:6], [pred] * 6, k=K)
        _held_to(v[:6], res, ref.batch_query(v[:6], [rpred] * 6, k=K))
        for pr in res:
            seen.add(pr.result.strategy)
            ids = pr.result.ids[0]
            assert not (set(ids[ids >= 0].tolist()) & dead), pr.result.strategy
    assert seen == {"ipre", "post"}


def test_upsert_of_existing_id_replaces(corpus):
    v, cat, num = corpus
    eng, ref = _pair(v, cat, num)
    args = (v[7:8], np.array([[2, 3]], np.int32), np.zeros((1, 2), np.float32))
    h = eng.upsert(*args, ids=np.array([7]))
    np.testing.assert_array_equal(h, ref.upsert(*args, ids=np.array([7])))
    assert eng.live.is_deleted(np.array([7]))[0]
    gt = eng.ground_truth(v[7], PRED, k=K)
    assert h[0] in gt[0] and 7 not in gt[0]
    np.testing.assert_array_equal(gt, ref.ground_truth(v[7], RPRED, k=K))
    r = eng.query(v[7], PRED, k=K)
    assert r.result.ids[0, 0] == h[0]


# ----------------------------------------------------------------------
# staleness-aware statistics
# ----------------------------------------------------------------------
def test_sel_is_exact_demotes_and_recovers(corpus):
    """Range buckets go stale on upsert (the estimate demotes to
    non-exact); label bitmaps extend and stay exact over the live rows;
    compaction rebuilds everything exact.  Estimates equal the reference's
    at every step."""
    v, cat, num = corpus
    eng, ref = _pair(v, cat, num)

    def same_estimates():
        for p, rp in ((PRED, RPRED), (PRED_LABEL, RPRED_LABEL), (PRED_RANGE, RPRED_RANGE)):
            a, b = eng.estimator.estimate(p), ref.estimator.estimate(rp)
            assert (a.sel, a.is_exact) == (b.sel, b.is_exact)

    assert eng.attr_index.covers(PRED_RANGE) and eng.estimator.estimate(PRED_RANGE).is_exact
    same_estimates()
    _mutate(eng, v, cat)
    _mutate(ref, v, cat)
    assert not eng.attr_index.covers(PRED_RANGE)
    assert not eng.estimator.estimate(PRED_RANGE).is_exact
    se = eng.estimator.estimate(PRED_LABEL)
    assert se.is_exact
    alive = eng.live.alive_mask()
    m = np.concatenate([cat[:, 0] == 1, eng.live.seg_cat()[:, 0] == 1]) & alive
    assert se.sel == pytest.approx(m.sum() / alive.sum())
    same_estimates()
    eng.compact()
    ref.compact()
    assert eng.attr_index.covers(PRED_RANGE) and eng.estimator.estimate(PRED_RANGE).is_exact
    same_estimates()


def test_stale_range_boundary_regression(corpus):
    """A range predicate whose matching rows are ONLY in the append
    segment: fail-closed scanning must find them."""
    v, cat, num = corpus
    eng, ref = _pair(v, cat, num)
    nv = np.random.default_rng(5).standard_normal((3, v.shape[1])).astype(np.float32)
    nm = np.full((3, 2), 99.0, np.float32)
    h = eng.upsert(nv, np.zeros((3, 2), np.int32), nm)
    ref.upsert(nv, np.zeros((3, 2), np.int32), nm)
    far = Predicate(ranges=(RangePred(0, ((98.0, 100.0),)),))
    rfar = rc.Predicate(ranges=(rc.RangePred(0, ((98.0, 100.0),)),))
    assert not eng.attr_index.covers(far)
    gt = eng.ground_truth(nv[0], far, k=K)
    assert set(gt[0][gt[0] >= 0].tolist()) == set(h.tolist())
    np.testing.assert_array_equal(gt, ref.ground_truth(nv[0], rfar, k=K))
    r = eng.query(nv[0], far, k=K)
    ids = r.result.ids[0]
    assert set(ids[ids >= 0].tolist()) == set(h.tolist())
    _held_to(nv[:1], [r], [ref.query(nv[0], rfar, k=K)])


def test_plan_epoch_and_cache_invalidation(corpus):
    """Upserts and deletes move the corpus generation, so memoised plans
    are dropped on the next lookup; upserts also invalidate compiled
    predicates (their word count changed), deletes do not."""
    v, cat, num = corpus
    eng = _build(v, cat, num)
    eng.query(v[0], PRED, k=K)
    assert eng.corpus_generation == 0 and eng.plan_cache.invalidations == 0
    eng.upsert(v[:1], np.array([[2, 3]], np.int32), np.zeros((1, 2), np.float32))
    eng.query(v[0], PRED, k=K)
    assert eng.corpus_generation == 1 and eng.plan_cache.invalidations >= 1
    inval = eng.pred_cache.invalidations
    assert inval >= 1
    eng.delete(np.array([3]))
    assert eng.pred_cache.invalidations == inval and eng.corpus_generation == 2
    assert eng._plan_epoch()[-1] == 2


# ----------------------------------------------------------------------
# merges and shards
# ----------------------------------------------------------------------
def test_merge_tolerates_starved_shard():
    da = np.array([[0.1, 0.5, 0.9, np.inf, np.inf]], np.float32)
    ia = np.array([[4, 9, 2, -1, -1]], np.int32)
    db = np.array([[0.2, 0.3, 0.6, 0.7, 1.1]], np.float32)
    ib = np.array([[10, 11, 12, 13, 14]], np.int32)
    for dd, ii in ((np.stack([da, db]), np.stack([ia, ib])),
                   (np.stack([da[:, :2], da[:, 3:]]), np.stack([ia[:, :2], ia[:, 3:]]))):
        d, i = merge_topk(dd, ii, 5)
        rd, ri = ref_merge_topk(dd, ii, 5)
        np.testing.assert_array_equal(i, np.asarray(ri))
        np.testing.assert_array_equal(d, np.asarray(rd))
    d, i = merge_topk(np.stack([da, db]), np.stack([ia, ib]), 5)
    np.testing.assert_array_equal(i[0], [4, 10, 11, 9, 12])
    d, i = merge_topk(np.stack([da[:, :2], da[:, 3:]]), np.stack([ia[:, :2], ia[:, 3:]]), 5)
    np.testing.assert_array_equal(i[0], [4, 9, -1, -1, -1])
    assert np.isinf(d[0][2:]).all()


def test_sharded_starved_shard_after_deletes(corpus):
    """Every PRED match on shard 0 deleted: the sharded merge stays exact,
    bit for bit against the port's flat engine and up to ties against the
    reference's sharded engine."""
    v, cat, num = corpus
    flat = _build(v, cat, num)
    sharded = ShardedANNEngine(_build(v, cat, num), n_shards=3)
    rsharded = RefSharded(RefEngine(v, cat, num, RefConfig(seed=0)).build(), n_shards=3)
    match = np.nonzero((cat[:, 0] == 2) & (cat[:, 1] == 3))[0]
    kill = match[np.isin(match, sharded.shards[0].ids)]
    assert kill.size
    np.testing.assert_array_equal(kill, match[np.isin(match, rsharded.shards[0].ids)])
    flat.delete(kill)
    sharded.delete(kill)
    rsharded.delete(kill)
    gt = flat.ground_truth(v[:5], PRED, k=K)
    res = sharded.batch_query(v[:5], [PRED] * 5, k=K)
    rres = rsharded.batch_query(v[:5], [RPRED] * 5, k=K)
    for i, pr in enumerate(res):
        assert pr.result.strategy in EXACT
        np.testing.assert_array_equal(pr.result.ids[0], gt[i])
        assert not np.isin(pr.result.ids[pr.result.ids >= 0], kill).any()
    _held_to(v[:5], res, rres)


def test_sharded_equals_flat_after_churn(corpus):
    """Deletes then upserts through a 3-shard engine and a flat one: the
    same handles, exact rows bit for bit equal (the port's shard merge
    breaks ties by handle, as the flat engine's base-first merge does),
    and after compaction the results keep translating through id_map."""
    v, cat, num = corpus
    flat = _build(v, cat, num)
    sharded = ShardedANNEngine(_build(v, cat, num), n_shards=3)
    rflat = RefEngine(v, cat, num, RefConfig(seed=0)).build()
    rng = np.random.default_rng(7)
    dead = rng.choice(len(v), 30, replace=False)
    flat.delete(dead)
    sharded.delete(dead)
    rflat.delete(dead)
    nv = np.concatenate([v[dead[-1:]], v[:1], rng.standard_normal((5, v.shape[1]))]).astype(np.float32)
    nc = np.tile(np.array([[2, 3]], np.int32), (7, 1))
    nm = np.zeros((7, 2), np.float32)
    hf = flat.upsert(nv, nc, nm)
    np.testing.assert_array_equal(hf, sharded.upsert(nv, nc, nm))
    rflat.upsert(nv, nc, nm)
    q = np.concatenate([v[:6], nv[:2]])
    gt = flat.ground_truth(q, PRED, k=K)
    np.testing.assert_array_equal(gt, rflat.ground_truth(q, RPRED, k=K))
    res = sharded.batch_query(q, [PRED] * len(q), k=K)
    fres = flat.batch_query(q, [PRED] * len(q), k=K)
    for i, pr in enumerate(res):
        assert pr.result.strategy in EXACT
        np.testing.assert_array_equal(pr.result.ids[0], gt[i])
        np.testing.assert_array_equal(pr.result.ids, fres[i].result.ids)
        np.testing.assert_array_equal(pr.result.dists, fres[i].result.dists)
        np.testing.assert_array_equal(sharded.query(q[i], PRED, K).result.ids, pr.result.ids)
    id_map = sharded.compact()
    gt2 = sharded.engine.ground_truth(q, PRED, k=K)
    np.testing.assert_array_equal(np.where(gt >= 0, id_map[np.maximum(gt, 0)], -1), gt2)
    res2 = sharded.batch_query(q, [PRED] * len(q), k=K)
    for i, pr in enumerate(res2):
        np.testing.assert_array_equal(pr.result.ids[0], gt2[i])


# ----------------------------------------------------------------------
# compaction policy
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_compaction_policy_thresholds(pkg):
    cls = CompactionPolicy if pkg == "port" else rc.CompactionPolicy
    pol = cls(max_tombstone_frac=0.2, max_segment_frac=0.3, max_list_drift=1.5)
    cases = [((0.1, 0.1, 1.0), False), ((0.25, 0.0, 1.0), True),
             ((0.0, 0.35, 1.0), True), ((0.0, 0.0, 2.0), True)]
    for args, due in cases:
        assert pol.due(*args) is due


def test_maybe_compact_triggers_on_churn(corpus):
    v, cat, num = corpus
    eng, ref = _pair(v, cat, num, max_tombstone_frac=0.01)
    assert eng.maybe_compact() is None
    eng.delete(np.arange(100))
    ref.delete(np.arange(100))
    assert eng.needs_compaction() and ref.needs_compaction()
    id_map = eng.maybe_compact()
    assert id_map is not None and eng.n_compactions == 1
    assert (id_map[:100] == -1).all()
    np.testing.assert_array_equal(id_map, ref.maybe_compact())


def test_list_drift_equals_reference(corpus):
    """Segment rows are coarse-assigned on the device as they arrive; the
    drift trigger reads the same assignments as the reference."""
    v, cat, num = corpus
    eng, ref = _pair(v, cat, num)
    assert eng.list_drift() == 1.0
    rng = np.random.default_rng(2)
    nv = (v[:40] + 0.01 * rng.standard_normal((40, v.shape[1]))).astype(np.float32)
    for e in (eng, ref):
        e.upsert(nv, cat[:40], num[:40])
    np.testing.assert_array_equal(eng.live.seg_assign, ref.live.seg_assign)
    assert eng.list_drift() == pytest.approx(ref.list_drift())
    assert eng.live.seg_vectors_dev().shape == (40, v.shape[1])


# ----------------------------------------------------------------------
# state across packages; the exact-copy tie
# ----------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_mutation_state_roundtrip_across_packages(corpus, direction):
    """A mutation_state() tree of one package, as numpy arrays, loads into
    the other's clean engine through load_mutation_state: the same live
    rows, the same live ground truth."""
    v, cat, num = corpus
    eng, ref = _pair(v, cat, num)
    src, dst = (ref, eng) if direction == "ref_to_port" else (eng, ref)
    _mutate(src, v, cat)
    tree = carry.mutation_tree(src.mutation_state())
    assert set(tree) == set(ref.mutation_state())
    dst.load_mutation_state(tree)
    assert dst.live.n_total == src.live.n_total
    assert dst.live.live_count == src.live.live_count
    np.testing.assert_array_equal(dst.live.tomb, src.live.tomb)
    q = v[:4]
    np.testing.assert_array_equal(eng.ground_truth(q, PRED, k=K), ref.ground_truth(q, RPRED, k=K))
    again = carry.mutation_tree(dst.mutation_state())
    for key in ("tomb", "seg_vectors", "seg_cat", "seg_num", "base_n"):
        np.testing.assert_array_equal(again[key], tree[key])
    with pytest.raises(ValueError):
        dst.load_mutation_state(tree)


def test_exact_copy_of_live_base_row_comes_after_it(corpus):
    """An upserted exact copy of a live base row ties it bit for bit: the
    base row (the lower handle) comes first in query(), batch_query(),
    the sharded path and ground truth, and still first after compaction
    and in a fresh build over the compacted corpus."""
    v, cat, num = corpus
    rows = np.nonzero((cat[:, 0] == 2) & (cat[:, 1] == 3))[0][:4]
    eng = _build(v, cat, num)
    sharded = ShardedANNEngine(_build(v, cat, num), n_shards=3)
    copies = eng.upsert(v[rows], cat[rows], num[rows])
    sharded.upsert(v[rows], cat[rows], num[rows])
    q = (v[rows] + 1e-3).astype(np.float32)     # near each row, not on it
    gt = eng.ground_truth(q, PRED, k=K)
    served = eng.batch_query(q, [PRED] * len(q), k=K)
    for j, r in enumerate(rows):
        for ids, d in ((served[j].result.ids[0], served[j].result.dists[0]),
                       (eng.query(q[j], PRED, K).result.ids[0], None),
                       (sharded.query(q[j], PRED, K).result.ids[0], None), (gt[j], None)):
            pos = list(ids)
            assert pos.index(r) + 1 == pos.index(copies[j]), (j, ids)
            if d is not None:
                assert d[pos.index(r)] == d[pos.index(copies[j])]
    id_map = eng.compact()
    fresh = _build(*eng.live.compacted()[:3])
    for e in (eng, fresh):
        for j, r in enumerate(rows):
            ids = list(e.query(q[j], PRED, K).result.ids[0])
            assert ids.index(id_map[r]) + 1 == ids.index(id_map[copies[j]])


def test_live_corpus_segment_buffer_grows_on_device(corpus):
    """The segment's device buffer doubles when an upsert outgrows it and
    always holds the host segment's rows."""
    v, cat, num = corpus
    live = LiveCorpus(v, cat, num, device="cpu")
    caps = []
    for s in range(0, 70, 7):
        live.upsert(v[s:s + 7], cat[s:s + 7], num[s:s + 7])
        caps.append(live._seg_dev.shape[0])
        np.testing.assert_array_equal(live.seg_vectors_dev().numpy(), live.seg_vectors())
    assert caps == sorted(caps) and len(set(caps)) < len(caps)
    assert all(c >= n for c, n in zip(caps, range(7, 71, 7)))
