"""The port's sharded serving path (``ShardedANNEngine``, ``reshard``) and
its fault/elastic helpers, against the JAX package's, on the CPU.

The cases of tests/test_dist_serve.py on a 2,000-row arxiv corpus made
with a fixed generator seed (``make_dataset``'s seed is offset by the
process's string hash, so the fixture passes ``BASE - hash("arxiv") %
2**16``: the same arrays under every hash seed).  Exact plans on the
shards equal the port's flat engine bit for bit and the reference's up to
ties; post plans, run on the reference's per-shard IVF layouts
(``carry.install_shard_ivfs``), equal the reference's sharded post rows up
to ties.  The sharded ``Or`` case is held to the port's and the
reference's FLAT engines: the reference's own sharded DNF test fails in
every run on record.
"""
import numpy as np
import pytest

import repro.core as rc
from repro.core import EngineConfig as RefConfig
from repro.core import FilteredANNEngine as RefEngine
from repro.core import trainer as ref_trainer
from repro.dist import HeartbeatMonitor as RefHeartbeat
from repro.dist import StragglerMitigator as RefStraggler
from repro.dist import merge_topk as ref_merge_topk
from repro.dist import replan_mesh as ref_replan_mesh
from repro.serve import ShardedANNEngine as RefSharded
from repro_torch import carry
from repro_torch.core import (
    EngineConfig,
    FilteredANNEngine,
    Or,
    Predicate,
    RangePred,
    gen_queries,
)
from repro_torch.data import make_dataset
from repro_torch.dist import HeartbeatMonitor, StragglerMitigator, merge_topk, replan_mesh
from repro_torch.serve import ShardedANNEngine
from test_torch_engine import _same_up_to_ties

K = 10
EXACT = (0, 2)
BASE_SEED = 64924        # the generator seed of PYTHONHASHSEED=34's "arxiv"


def fixed_dataset(scale: str):
    return make_dataset("arxiv", scale, seed=BASE_SEED - hash("arxiv") % 2**16)


@pytest.fixture(scope="module")
def small_system():
    ds = fixed_dataset("2000")
    eng = FilteredANNEngine(ds.vectors, ds.cat, ds.num, EngineConfig(seed=0, device="cpu")).build()
    ref = RefEngine(ds.vectors, ds.cat, ds.num, RefConfig(seed=0)).build()
    carry.install(eng, centroids=ref.ivf.centroids, assignment=carry.ivf_assignment(ref.ivf))
    tq, tp, _ = gen_queries(ds.vectors, ds.cat, ds.num, 8, kinds=ds.filter_kinds, seed=1)
    _, rtp, _ = ref_trainer.gen_queries(ds.vectors, ds.cat, ds.num, 8,
                                        kinds=ds.filter_kinds, seed=1)
    return ds, eng, ref, tq, tp, rtp


def _sharded_pair(small_system, n_shards):
    """Port and reference sharded engines over the fixture's engines, the
    port's shards on the reference's per-shard IVF layouts."""
    _, eng, ref, *_ = small_system
    sh, rsh = ShardedANNEngine(eng, n_shards=n_shards), RefSharded(ref, n_shards=n_shards)
    carry.install_shard_ivfs(sh.shards, carry.shard_ivf_layouts(rsh.shards))
    return sh, rsh


# ----------------------------------------------------------------------
# merges and the host helpers
# ----------------------------------------------------------------------
def test_merge_topk_matches_bruteforce_and_reference():
    rng = np.random.default_rng(3)
    b, n, k, n_shards = 5, 512, 10, 4
    d_all = rng.normal(0, 1, (b, n)).astype(np.float32) ** 2
    rows = np.arange(b)[:, None]
    sd, si = [], []
    for ids in np.array_split(np.arange(n), n_shards):
        order = np.argsort(d_all[:, ids], axis=1)[:, :k]
        sd.append(d_all[:, ids][rows, order])
        si.append(ids[order].astype(np.int32))
    md, mi = merge_topk(np.stack(sd), np.stack(si), k)
    np.testing.assert_allclose(md, np.sort(d_all, axis=1)[:, :k])
    rd, ri = ref_merge_topk(np.stack(sd), np.stack(si), k)
    np.testing.assert_array_equal(mi, np.asarray(ri))
    np.testing.assert_array_equal(md, np.asarray(rd))
    d = np.array([[[1.0, np.inf, np.inf]], [[np.inf, 2.0, 3.0]]], np.float32)
    i = np.array([[[7, -1, -1]], [[-1, 9, 11]]], np.int32)
    assert merge_topk(d, i, 4)[1][0].tolist() == [7, 9, 11, -1]
    assert merge_topk(d, i, 10)[1][0].tolist() == [7, 9, 11] + [-1] * 7


def test_fault_monitors_equal_reference():
    """The same virtual beat / step-time traces flag the same hosts at the
    same steps in both packages."""
    hb, rhb = HeartbeatMonitor(4, timeout=0.05), RefHeartbeat(4, timeout=0.05)
    sm, rsm = StragglerMitigator(4, min_observations=3), RefStraggler(4, min_observations=3)
    got, want = [], []
    now = 0.0
    for step in range(14):
        now += 0.01
        for h in range(4):
            if not (h == 1 and 3 <= step < 10):   # host 1 dies, then beats again
                hb.beat(h, now)
                rhb.beat(h, now)
            t = 0.1 * (3.0 if h == 3 else 1.0) + 0.001 * step
            sm.record(h, t)
            rsm.record(h, t)
        got += [(e.host, e.step, e.kind) for e in hb.check(step, now) + sm.check(step)]
        want += [(e.host, e.step, e.kind) for e in rhb.check(step, now) + rsm.check(step)]
        assert hb.alive == rhb.alive
    assert got == want
    assert ("dead_host" in [g[2] for g in got]) and ("straggler" in [g[2] for g in got])


@pytest.mark.parametrize("args", [(3, 1), (512, 16), (30 * 16, 16), (512, 16, True)])
def test_replan_mesh_equals_reference(args):
    assert replan_mesh(*args) == ref_replan_mesh(*args)


@pytest.mark.parametrize("args", [(3, 2), (8, 16), (10, 0), (300, 4, True)])
def test_replan_mesh_refuses_like_reference(args):
    with pytest.raises(ValueError):
        ref_replan_mesh(*args)
    with pytest.raises(ValueError):
        replan_mesh(*args)


# ----------------------------------------------------------------------
# the sharded path
# ----------------------------------------------------------------------
def test_default_shard_count():
    ds = fixed_dataset("300")
    eng = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                            EngineConfig(seed=0, device="cpu", sample_frac=1.0)).build_stats()
    assert ShardedANNEngine(eng).n_shards == 1


def test_sharded_matches_unsharded_and_reference(small_system):
    ds, eng, ref, tq, tp, rtp = small_system
    sh, rsh = _sharded_pair(small_system, 4)
    assert [s.ids.tolist() for s in sh.shards] == [s.ids.tolist() for s in rsh.shards]
    for s in sh.shards:      # a shard's device rows are a view of the corpus
        assert s.pre_exec.vectors.data_ptr() == eng.vectors_dev[int(s.ids[0])].data_ptr()
    seen = set()
    for i in range(len(tp)):
        r0 = eng.query(tq[i], tp[i], k=K)
        r1 = sh.query(tq[i], tp[i], k=K)
        rr = rsh.query(tq[i], rtp[i], k=K)
        assert r0.decision == r1.decision == rr.decision
        seen.add(r1.decision)
        _same_up_to_ties(tq[i], r1.result.ids, r1.result.dists, rr.result.ids, rr.result.dists)
        assert r1.result.n_expansions == rr.result.n_expansions
        if r1.decision in EXACT:
            np.testing.assert_array_equal(r1.result.ids, r0.result.ids)
            np.testing.assert_array_equal(r1.result.ids, eng.ground_truth(tq[i], tp[i], K))
        else:
            gt = set(eng.ground_truth(tq[i], tp[i], k=K)[0].tolist()) - {-1}
            got = set(r1.result.ids[0].tolist()) - {-1}
            assert len(gt & got) >= 0.8 * len(gt)
    assert seen == {1, 2}
    batch = sh.batch_query(tq, tp, K)
    for i, b in enumerate(batch):
        np.testing.assert_array_equal(b.result.ids, sh.query(tq[i], tp[i], K).result.ids)


def test_sharded_results_satisfy_predicate(small_system):
    ds, _, _, tq, tp, _ = small_system
    sh, _ = _sharded_pair(small_system, 3)
    for i in range(len(tp)):
        ids = sh.query(tq[i], tp[i], k=K).result.ids
        ids = ids[ids >= 0]
        assert ids.size and tp[i].eval(ds.cat[ids], ds.num[ids]).all()


def _dnf(p, ds):
    lo = float(np.quantile(ds.num[:, 0], 0.3))
    hi = float(np.quantile(ds.num[:, 0], 0.6))
    return p.Or((
        p.Predicate(labels=(p.LabelEq(0, int(ds.cat[0, 0])),)),
        p.Predicate(ranges=(p.RangePred(0, ((lo, hi),)),),
                    nots=(p.Not(p.LabelEq(1, int(ds.cat[1, 1]))),)),
    ))


def test_sharded_dnf_held_to_flat(small_system):
    """An ``Or`` with a negated leaf plans once, fans out and merges; its
    exact clauses equal the port's flat engine bit for bit and the
    reference's flat engine up to ties (not the reference's sharded path,
    whose own DNF test fails in every run on record)."""
    import repro_torch.core as pc

    ds, eng, ref, tq, _, _ = small_system
    dnf, rdnf = _dnf(pc, ds), _dnf(rc, ds)
    assert isinstance(dnf, Or)
    sh, _ = _sharded_pair(small_system, 3)
    for i in range(4):
        single = sh.query(tq[i], dnf, k=K)
        flat = eng.query(tq[i], dnf, k=K)
        rflat = ref.query(tq[i], rdnf, k=K)
        assert single.plan.is_dnf and [c.decision for c in single.plan.clauses] == \
            [c.decision for c in rflat.plan.clauses]
        ids = single.result.ids[single.result.ids >= 0]
        assert ids.size and dnf.eval(ds.cat[ids], ds.num[ids]).all()
        if all(c.decision in EXACT for c in single.plan.clauses):
            np.testing.assert_array_equal(single.result.ids, flat.result.ids)
            np.testing.assert_array_equal(single.result.dists, flat.result.dists)
            _same_up_to_ties(tq[i], single.result.ids, single.result.dists,
                             rflat.result.ids, rflat.result.dists)
    batch = sh.batch_query(tq[:4], [dnf] * 4, k=K)
    for i, r in enumerate(batch):
        np.testing.assert_array_equal(r.result.ids, sh.query(tq[i], dnf, k=K).result.ids)


def test_sharded_empty_predicate_and_tiny_shards(small_system):
    ds, _, _, tq, tp, _ = small_system
    nothing = Predicate(labels=(), ranges=(RangePred(attr=0, intervals=((1e9, 2e9),)),))
    sh, _ = _sharded_pair(small_system, 2)
    r = sh.query(tq[0], nothing, k=5)
    assert (r.result.ids == -1).all() and np.isinf(r.result.dists).all()
    few = FilteredANNEngine(ds.vectors[:10], ds.cat[:10], ds.num[:10],
                            EngineConfig(seed=0, sample_frac=1.0, device="cpu")).build_stats()
    tiny = ShardedANNEngine(few, n_shards=16)
    assert 0 < len(tiny.shards) <= 10
    assert sum(s.ids.size for s in tiny.shards) == 10
    assert tiny.query(tq[0], tp[0], k=3).result.ids.shape == (1, 3)


def test_dead_shard_detection_replans_and_merge_stays_exact(small_system):
    """A shard that stops beating is flagged once, ``replan_mesh`` gives the
    survivors' mesh, ``reshard`` repartitions the live deployment (with
    upserts and deletes in it), and exact plans stay bit for bit equal to
    the flat engine, as in the reference."""
    ds, _, _, tq, tp, rtp = small_system
    eng = FilteredANNEngine(ds.vectors, ds.cat, ds.num, EngineConfig(seed=0, device="cpu")).build()
    flat = FilteredANNEngine(ds.vectors, ds.cat, ds.num, EngineConfig(seed=0, device="cpu")).build()
    sharded = ShardedANNEngine(eng, n_shards=4)
    rng = np.random.default_rng(13)
    rows = rng.choice(ds.vectors.shape[0], 24, replace=False)
    dead = rng.choice(ds.vectors.shape[0], 30, replace=False)
    for e in (sharded, flat):
        e.upsert(ds.vectors[rows], ds.cat[rows], ds.num[rows])
        e.delete(dead)
    exact = [(q, p) for q, p in zip(tq, tp) if flat.query(q, p, k=K).decision in EXACT]
    assert exact, "the fixture must hold an exact-plan query"
    hb = HeartbeatMonitor(n_hosts=4, timeout=0.05)
    events, now = [], 0.0
    for step in range(12):                      # virtual serving loop
        now += 0.01
        for si in range(4):
            if not (si == 2 and step >= 4):
                hb.beat(si, now)
        events += hb.check(step, now)
        q, p = exact[step % len(exact)]
        sharded.query(q, p, k=K)
    assert [(e.kind, e.host) for e in events] == [("dead_host", 2)]
    survivors = len(hb.alive)
    assert replan_mesh(survivors, model_parallel=1) == ((3, 1), ("data", "model"))
    sharded.reshard(survivors)
    assert len(sharded.shards) == 3
    assert sum(len(s.ids) for s in sharded.shards) == flat.live.n_total
    for q, p in exact:
        merged = sharded.query(q, p, k=K)
        want = flat.query(q, p, k=K)
        np.testing.assert_array_equal(merged.result.ids, want.result.ids)
        np.testing.assert_array_equal(merged.result.dists, want.result.dists)
        assert not np.isin(merged.result.ids, dead).any()
    with pytest.raises(ValueError):
        sharded.reshard(0)
