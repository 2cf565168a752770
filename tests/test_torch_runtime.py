"""The port's serving runtime (``repro_torch.runtime``) against the JAX
package's, on the CPU.

One 4,000-row arxiv fixture per module; both packages get the same arrays
and each its own predicates from its own ``gen_queries`` (equal seeds give
equal queries).  The engines are unfitted (the selectivity-threshold
planner, as in the reference's runtime tests) and the port carries the
reference's IVF layout, so plans agree and post rows answer alike.

Held equal to the reference: traces from a seed (bit for bit), replay
batches, decisions, virtual latencies and ``counters()``; ids up to ties.
Held within the port: replay determinism, ids independent of batch
composition, deadline preemption, ``max_wait``, the sharded runtime, and
the feedback loop (its sampling, log, holdout and guard against the
reference's under a deterministic labeler and one carried candidate; a
recovery run of its own, with no wall-clock labels).
"""
import dataclasses

import numpy as np
import pytest

import repro.runtime as rr
import repro.runtime.feedback as ref_feedback_mod
from repro.core import EngineConfig as RefConfig
from repro.core import FilteredANNEngine as RefEngine
from repro.core import Or as RefOr
from repro.core import trainer as ref_trainer
from repro.serve import ShardedANNEngine as RefSharded
from repro_torch import carry
from repro_torch.core import (
    POST_FILTER,
    PRE_FILTER,
    EngineConfig,
    FilteredANNEngine,
    Or,
    gen_queries,
)
from repro_torch.core.planner import CorePlanner
import repro_torch.runtime as pr
import repro_torch.runtime.feedback as port_feedback_mod
from repro_torch.data import make_dataset
from repro_torch.serve import ShardedANNEngine
from test_torch_engine import _same_up_to_ties, _threshold_head

K = 10
CFG = dict(max_batch=16, max_wait=0.004)


def _pair(ds, **cfg):
    """A reference engine and the port's over ``ds``, the port on the
    reference's IVF layout."""
    ref = RefEngine(ds.vectors, ds.cat, ds.num, RefConfig(n_lists=32, seed=0, **cfg)).build()
    port = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                             EngineConfig(n_lists=32, seed=0, device="cpu", **cfg)).build()
    carry.install(port, centroids=ref.ivf.centroids, assignment=carry.ivf_assignment(ref.ivf))
    return port, ref


@pytest.fixture(scope="module")
def system():
    ds = make_dataset("arxiv", "4000", seed=0)
    port, ref = _pair(ds)
    qs, preds, _ = gen_queries(ds.vectors, ds.cat, ds.num, 16, kinds=ds.filter_kinds,
                               sel_range=(0.01, 0.4), seed=2)
    _, rpreds, _ = ref_trainer.gen_queries(ds.vectors, ds.cat, ds.num, 16,
                                           kinds=ds.filter_kinds, sel_range=(0.01, 0.4), seed=2)
    # two unions in the pool: the runtime plans them per disjunct
    preds = list(preds) + [Or((preds[0], preds[1])), Or((preds[2], preds[3], preds[0]))]
    rpreds = list(rpreds) + [RefOr((rpreds[0], rpreds[1])),
                             RefOr((rpreds[2], rpreds[3], rpreds[0]))]
    return ds, port, ref, qs, preds, rpreds


def _traces(qs, preds, rpreds, kind="poisson", n=120, rate=3000.0, seed=5, **kw):
    gen, rgen = {"poisson": (pr.poisson_trace, rr.poisson_trace),
                 "bursty": (pr.bursty_trace, rr.bursty_trace)}[kind]
    return (gen(qs, preds, n, rate, k=K, seed=seed, **kw),
            rgen(qs, rpreds, n, rate, k=K, seed=seed, **kw))


def _same_trace(t, rt, preds, rpreds):
    """Requests equal field by field; predicates compared by pool index."""
    assert (t.kind, t.rate, t.seed, len(t)) == (rt.kind, rt.rate, rt.seed, len(rt))
    pi = {id(p): i for i, p in enumerate(preds)}
    rpi = {id(p): i for i, p in enumerate(rpreds)}
    for a, b in zip(t, rt):
        assert (a.rid, a.t_arrival, a.k, a.tier, a.deadline, a.op, a.tenant) == \
               (b.rid, b.t_arrival, b.k, b.tier, b.deadline, b.op, b.tenant)
        if a.op == "query":
            assert pi[id(a.pred)] == rpi[id(b.pred)]
            assert a.query.tobytes() == b.query.tobytes()
        else:
            assert a.pred is None and b.pred is None
            for x, y in zip(a.payload, b.payload):
                np.testing.assert_array_equal(x, y)


def _sig(plan):
    return (plan.merge, plan.est, [(c.decision, c.route, c.backend, c.knob, c.est)
                                   for c in plan.clauses])


def _check_ids(qs_of, rep, rrep, exact_only=False):
    """Plans equal the reference's, ids up to ties (only the exact plans'
    with ``exact_only``)."""
    for rid, res in rep.results.items():
        rres = rrep.results[rid]
        assert _sig(res.plan) == _sig(rres.plan)
        if exact_only and any(c.decision == POST_FILTER for c in res.plan.clauses):
            continue
        _same_up_to_ties(qs_of[rid], res.result.ids, res.result.dists,
                         rres.result.ids, rres.result.dists)


def _query_of(trace):
    return {r.rid: r.query for r in trace if r.op == "query"}


# ----------------------------------------------------------------------
# traces
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_traces_equal_reference(system, kind):
    ds, _, _, qs, preds, rpreds = system
    t, rt = _traces(qs, preds, rpreds, kind, n=300, seed=3)
    _same_trace(t, rt, preds, rpreds)
    # with writes: upserts from a row pool, deletes from a handle pool
    wc = (ds.vectors[:20], ds.cat[:20], ds.num[:20])
    t, rt = _traces(qs, preds, rpreds, kind, n=300, seed=4, write_frac=0.2,
                    write_corpus=wc, delete_pool=np.arange(100, 140))
    _same_trace(t, rt, preds, rpreds)
    assert {r.op for r in t} == {"query", "upsert", "delete"}


def test_multi_tenant_trace_equals_reference(system):
    _, _, _, qs, preds, rpreds = system
    specs = [pr.TenantTraceSpec("a", qs, preds, 90, 800.0),
             pr.TenantTraceSpec("b", qs, preds, 120, 1500.0, kind="bursty",
                                tier_mix={"standard": 1.0})]
    rspecs = [rr.TenantTraceSpec("a", qs, rpreds, 90, 800.0),
              rr.TenantTraceSpec("b", qs, rpreds, 120, 1500.0, kind="bursty",
                                 tier_mix={"standard": 1.0})]
    t = pr.multi_tenant_trace(specs, seed=7)
    rt = rr.multi_tenant_trace(rspecs, seed=7)
    _same_trace(t, rt, preds, rpreds)
    assert [r.tenant for r in t].count("b") == 120
    with pytest.raises(ValueError):
        pr.multi_tenant_trace([specs[0], specs[0]])


@pytest.mark.parametrize("gen", [pr.poisson_trace, pr.bursty_trace])
@pytest.mark.parametrize("kw", [{"write_frac": 1.5}, {"write_frac": -0.1},
                                {"upsert_frac": 2.0}, {"upsert_frac": -1e-9}])
def test_trace_generators_reject_bad_write_fracs(system, gen, kw):
    _, _, _, qs, preds, _ = system
    with pytest.raises(ValueError):
        gen(qs, preds, 10, 100.0, seed=0, **kw)
    gen(qs, preds, 10, 100.0, seed=0, write_frac=0.0, upsert_frac=1.0)


# ----------------------------------------------------------------------
# replay against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_replay_equals_reference(system, kind):
    _, port, ref, qs, preds, rpreds = system
    t, rt = _traces(qs, preds, rpreds, kind, seed=8)
    rep = pr.OnlineRuntime(port, pr.SchedulerConfig(**CFG)).run_trace(t)
    rrep = rr.OnlineRuntime(ref, rr.SchedulerConfig(**CFG)).run_trace(rt)
    assert rep.batches == rrep.batches
    assert rep.telemetry.counters() == rrep.telemetry.counters()
    s, rs = rep.telemetry.snapshot(), rrep.telemetry.snapshot()
    for key in ("latency_virtual", "latency_by_tier", "queue_wait_virtual"):
        assert s[key] == rs[key], key
    assert {r.decision for r in rep.results.values()} >= {POST_FILTER}
    assert any(r.plan.is_dnf for r in rep.results.values())
    _check_ids(_query_of(t), rep, rrep)


def test_replay_deterministic(system):
    _, port, _, qs, preds, rpreds = system
    t, _ = _traces(qs, preds, rpreds)
    a = pr.OnlineRuntime(port, pr.SchedulerConfig(**CFG)).run_trace(t)
    b = pr.OnlineRuntime(port, pr.SchedulerConfig(**CFG)).run_trace(t)
    assert a.batches == b.batches
    assert a.telemetry.counters() == b.telemetry.counters()
    assert a.telemetry.snapshot()["latency_by_tier"] == b.telemetry.snapshot()["latency_by_tier"]
    for rid in a.results:
        np.testing.assert_array_equal(a.ids(rid), b.ids(rid))
        np.testing.assert_array_equal(a.results[rid].result.dists, b.results[rid].result.dists)


def test_ids_independent_of_batch_composition(system):
    _, port, _, qs, preds, rpreds = system
    t, _ = _traces(qs, preds, rpreds, n=60, seed=9)
    small = pr.OnlineRuntime(port, pr.SchedulerConfig(max_batch=2)).run_trace(t)
    large = pr.OnlineRuntime(port, pr.SchedulerConfig(max_batch=64, max_wait=0.05)).run_trace(t)
    assert small.batches != large.batches
    for r in t:
        direct = port.query(r.query, r.pred, r.k)
        np.testing.assert_array_equal(small.ids(r.rid), direct.result.ids[0])
        np.testing.assert_array_equal(large.ids(r.rid), direct.result.ids[0])


def test_every_request_answered_once(system):
    _, port, _, qs, preds, rpreds = system
    t, _ = _traces(qs, preds, rpreds, kind="bursty", n=100, seed=10)
    rep = pr.OnlineRuntime(port, pr.SchedulerConfig(max_batch=8)).run_trace(t)
    flat = [rid for b in rep.batches for rid in b]
    assert sorted(flat) == list(range(100)) and set(rep.results) == set(flat)
    assert all(1 <= len(b) <= 8 for b in rep.batches)


def _req(rid, t, q, pred, tier):
    return pr.RuntimeRequest(rid=rid, t_arrival=t, query=q, pred=pred, k=K, tier=tier,
                             deadline=t + pr.SLO_TIERS[tier])


def test_deadline_preemption(system):
    """A tight-deadline arrival flushes the forming batch long before
    max_wait and runs at its head."""
    _, port, _, qs, preds, _ = system
    reqs = [_req(i, 0.001 * i, qs[0], preds[0], "batch") for i in range(3)]
    reqs.append(_req(3, 0.003, qs[0], preds[0], "interactive"))
    rep = pr.OnlineRuntime(port, pr.SchedulerConfig(max_batch=64, max_wait=10.0)).run_trace(
        pr.ArrivalTrace(reqs, "poisson", 1000.0, 0))
    assert rep.batches == [[3, 0, 1, 2]]
    c = rep.telemetry.counters()
    assert c["deadline_flushes"] == 1 and c["deadline_met"]["interactive"] == 1
    assert rep.telemetry.snapshot()["latency_virtual"]["max"] < 1.0


def test_max_wait_bounds_queue_age(system):
    _, port, _, qs, preds, rpreds = system
    t, _ = _traces(qs, preds, rpreds, n=60, rate=500.0, seed=11)
    rep = pr.OnlineRuntime(port, pr.SchedulerConfig(max_batch=64, max_wait=0.004)).run_trace(t)
    bound = 0.004 + pr.ServiceModel().estimate(64)
    assert rep.telemetry.snapshot()["queue_wait_virtual"]["max"] <= bound + 1e-9


def test_sharded_runtime_matches_sharded_query_and_reference(system):
    _, port, ref, qs, preds, rpreds = system
    sh, rsh = ShardedANNEngine(port, n_shards=3), RefSharded(ref, n_shards=3)
    carry.install_shard_ivfs(sh.shards, carry.shard_ivf_layouts(rsh.shards))
    t, rt = _traces(qs, preds, rpreds, n=40, seed=12)
    rep = sh.runtime(pr.SchedulerConfig(max_batch=16)).run_trace(t)
    rrep = rsh.runtime(rr.SchedulerConfig(max_batch=16)).run_trace(rt)
    assert rep.batches == rrep.batches
    assert rep.telemetry.counters() == rrep.telemetry.counters()
    for r in t:
        np.testing.assert_array_equal(rep.ids(r.rid), sh.query(r.query, r.pred, r.k).result.ids[0])
    _check_ids(_query_of(t), rep, rrep)
    s = sh.stats()
    assert s["shard_pred_cache"]["n_shards"] == 3 and s["plan_cache"]["hits"] > 0
    assert set(s) == set(rsh.stats())


@pytest.mark.parametrize("max_tomb", [0.2, 0.004])
def test_live_replay_equals_reference(system, max_tomb):
    """Writes interleaved with reads: the same batches and counters (writes,
    and at the low threshold a compaction) as the reference; ids up to ties.
    Without compaction no tombstoned id is served.  After a compaction each
    package's post rows run on its own rebuilt IVF, so there only the exact
    plans' ids and the counters that post rows do not set are held."""
    ds = system[0]
    port, ref = _pair(ds, max_tombstone_frac=max_tomb)
    _, _, _, qs, preds, rpreds = system
    wc = (ds.vectors[:40] + 0.01, ds.cat[:40], ds.num[:40])
    t, rt = _traces(qs, preds, rpreds, n=200, seed=13, write_frac=0.25, write_corpus=wc,
                    delete_pool=np.arange(0, 4000, 97))
    rep = pr.OnlineRuntime(port, pr.SchedulerConfig(**CFG)).run_trace(t)
    rrep = rr.OnlineRuntime(ref, rr.SchedulerConfig(**CFG)).run_trace(rt)
    assert rep.batches == rrep.batches
    c, rc_ = rep.telemetry.counters(), rrep.telemetry.counters()
    assert c["n_upserts"] > 0 and c["n_deletes"] > 0
    compacted = port.n_compactions > 0
    assert compacted == (max_tomb < 0.01) and port.n_compactions == ref.n_compactions
    if compacted:
        for key in ("fill_rate", "mean_expansions"):
            c.pop(key), rc_.pop(key)
    assert c == rc_
    _check_ids(_query_of(t), rep, rrep, exact_only=compacted)
    if not compacted:
        # a batch's writes apply before its reads: replay the deletes in
        # flush order and check every read against the handles dead by then
        by_rid, dead = {r.rid: r for r in t}, set()
        for batch in rep.batches:
            for rid in sorted(batch):
                if by_rid[rid].op == "delete":
                    dead.update(by_rid[rid].payload[0].tolist())
            for rid in batch:
                if by_rid[rid].op == "query":
                    ids = rep.results[rid].result.ids
                    assert not dead & set(ids[ids >= 0].tolist()), rid
        assert dead


# ----------------------------------------------------------------------
# feedback
# ----------------------------------------------------------------------
def _threshold_labeler(eng, cut=0.08):
    """Deterministic oracle: post-filter wins above the selectivity cut."""
    def labeler(req):
        return POST_FILTER if eng.estimator.estimate(req.pred).sel >= cut else PRE_FILTER
    return labeler


def _feedback_pair(system, cfg):
    _, port, ref, qs, preds, rpreds = system
    state = _threshold_head(0.05)
    ref.planner.load_state(state)
    ref.plan_cache.clear()
    carry.install(port, planner=ref.planner.state_dict())
    fb = pr.OnlineFeedback(port, pr.FeedbackConfig(**cfg), labeler=_threshold_labeler(port))
    rfb = rr.OnlineFeedback(ref, rr.FeedbackConfig(**cfg), labeler=_threshold_labeler(ref))
    return fb, rfb


def test_feedback_log_equals_reference(system):
    """Which rows are sampled, and the log's features, decisions, labels and
    routes, equal the reference's under a deterministic labeler."""
    _, port, ref, qs, preds, rpreds = system
    fb, rfb = _feedback_pair(system, dict(sample_rate=0.3, refit_every=10**9, seed=7))
    t, rt = _traces(qs, preds, rpreds, n=120, seed=14)
    rep = pr.OnlineRuntime(port, pr.SchedulerConfig(**CFG), feedback=fb).run_trace(t)
    rrep = rr.OnlineRuntime(ref, rr.SchedulerConfig(**CFG), feedback=rfb).run_trace(rt)
    assert rep.batches == rrep.batches
    assert fb.stats() == rfb.stats()
    assert 0 < fb.n_sampled < fb.n_observed == 120
    assert len(fb.log) == len(rfb.log) == fb.n_sampled
    for e, re_ in zip(fb.log, rfb.log):
        np.testing.assert_array_equal(e.features, re_.features)
        assert (e.decision, e.label, e.route) == (re_.decision, re_.label, re_.route)


def test_feedback_holdout_and_guard_equal_reference(system, monkeypatch):
    """With one carried candidate state, both packages hold out the same
    rows, score the candidate and the current head alike and take the same
    swap decision; an impossible AUC bar keeps the head in both."""
    _, port, ref, qs, preds, rpreds = system
    for slack, want in ((0.0, None), (-10.0, False)):
        fb, rfb = _feedback_pair(system, dict(sample_rate=1.0, refit_every=10**9,
                                              auc_slack=slack, seed=1))
        for r, x in zip(*_traces(qs, preds, rpreds, n=60, seed=15)):
            fb.observe(r, port.query(r.query, r.pred, r.k))
            rfb.observe(x, ref.query(x.query, x.pred, x.k))
        seen = {"port": [], "ref": []}
        for mod, key in ((port_feedback_mod, "port"), (ref_feedback_mod, "ref")):
            monkeypatch.setattr(mod, "roc_auc", (lambda f, k: lambda y, s: (
                seen[k].append((np.asarray(y), np.asarray(s))) or f(y, s)))(mod.roc_auc, key))
        cands = []

        class Recording(rr.feedback.CorePlanner):
            def fit(self, *a, **kw):
                cands.append(self)
                return super().fit(*a, **kw)

        monkeypatch.setattr(ref_feedback_mod, "CorePlanner", Recording)
        r_swap = rfb.refit()
        monkeypatch.setattr(fb, "_fit_candidate", lambda x, y, train: carry.planner_from_state(
            cands[-1].state_dict(), device="cpu"))
        swap = fb.refit()
        assert swap == r_swap and (want is None or swap is want)
        assert (fb.n_refits, fb.n_swaps) == (rfb.n_refits, rfb.n_swaps)
        assert len(seen["port"]) == len(seen["ref"]) == 2      # candidate, current
        for (y, s), (ry, rs) in zip(seen["port"], seen["ref"]):
            np.testing.assert_array_equal(y, ry)
            np.testing.assert_allclose(s, rs, rtol=1e-5, atol=1e-6)
        monkeypatch.undo()
    carry.install(port, planner=ref.planner.state_dict())


def test_feedback_recovers_warped_planner(system):
    """A head fit on inverted labels recovers once the log (deterministic
    labels, every request sampled) is replayed through refit."""
    _, port, _, qs, preds, rpreds = system
    conj = [p for p in preds if not isinstance(p, Or)]
    labeler = _threshold_labeler(port)
    feats, bad = [], []
    for p in conj:
        se = port.estimator.estimate(p)
        feats.append(port.feat.vector(p, se.sel, K, se.is_exact))
        bad.append(PRE_FILTER if se.sel >= 0.08 else POST_FILTER)
    port.swap_planner(CorePlanner(seed=3, device="cpu").fit(np.stack(feats), np.asarray(bad)))

    def acc():
        good = 0
        for p, fv in zip(conj, feats):
            want = labeler(pr.RuntimeRequest(0, 0.0, qs[0], p, K))
            d = int(port.planner.decide(fv)[0])
            good += int((POST_FILTER if d == POST_FILTER else PRE_FILTER) == want)
        return good / len(conj)

    warped = acc()
    fb = pr.OnlineFeedback(port, pr.FeedbackConfig(sample_rate=1.0, refit_every=60,
                                                    min_examples=40, seed=0), labeler=labeler)
    t = pr.poisson_trace(qs, conj, 140, 3000.0, k=K, seed=17)
    pr.OnlineRuntime(port, pr.SchedulerConfig(max_batch=32), feedback=fb).run_trace(t)
    assert fb.n_swaps >= 1 and fb.stats()["sampled"] == 140
    assert acc() > warped and acc() >= 0.85, (acc(), warped)
    port.swap_planner(CorePlanner(seed=0, device="cpu"))     # back to the untrained head


def test_feedback_requires_built_engine(system):
    ds = system[0]
    stats_only = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                                   EngineConfig(seed=0, device="cpu")).build_stats()
    with pytest.raises(ValueError, match="fully built"):
        pr.OnlineFeedback(stats_only)


# ----------------------------------------------------------------------
# a routed engine under the reference's routing head
# ----------------------------------------------------------------------
def test_routed_replay_and_backend_mix_equal_reference(system):
    """Batches, counters (the backend-mix counter included) and per-row
    (decision, backend, knob) equal the reference's; ids up to ties; the
    port's replay is bit-identical."""
    ds, _, _, qs, preds, rpreds = system
    backends = ("flat", "ivf", "ivfpq")
    port, ref = _pair(ds, backends=backends)
    conj = [p for p in preds if not isinstance(p, Or)]
    rconj = [p for p in rpreds if not isinstance(p, RefOr)]
    ref.planner.load_state(_threshold_head(0.05))
    feats = np.stack([ref.feat.vector(p, se.sel, K, se.is_exact)
                      for p, se in ((p, ref.estimator.estimate(p)) for p in rconj)])
    names = ref.backend_set.class_names()
    labels = np.arange(len(rconj)) % len(names)
    ref.planner.fit_routing(feats, labels, names)
    ref.plan_cache.clear()
    rb = ref.backend_set.backends
    carry.install(port, planner=ref.planner.state_dict(),
                  backend_ivf=(rb["ivf"].index.centroids, carry.ivf_assignment(rb["ivf"].index)),
                  ivfpq=carry.ivfpq_state(rb["ivfpq"].index))
    t, rt = _traces(qs, conj, rconj, n=80, seed=18)
    a = pr.OnlineRuntime(port, pr.SchedulerConfig(max_batch=8)).run_trace(t)
    b = pr.OnlineRuntime(port, pr.SchedulerConfig(max_batch=8)).run_trace(t)
    rrep = rr.OnlineRuntime(ref, rr.SchedulerConfig(max_batch=8)).run_trace(rt)
    assert a.batches == b.batches == rrep.batches
    c = a.telemetry.counters()
    assert c == b.telemetry.counters() == rrep.telemetry.counters()
    assert sum(c["backend_counts"].values()) == 80
    assert len({k for k in c["backend_counts"] if not k.startswith("flat")}) >= 2
    for rid, res in a.results.items():
        x = rrep.results[rid]
        assert (res.decision, res.result.backend, res.result.knob) == \
               (x.decision, x.result.backend, x.result.knob)
        np.testing.assert_array_equal(res.result.ids, b.results[rid].result.ids)
    _check_ids(_query_of(t), a, rrep)


def test_runtime_request_fields_equal_reference():
    names = [f.name for f in dataclasses.fields(pr.RuntimeRequest)]
    assert names == [f.name for f in dataclasses.fields(rr.RuntimeRequest)]
    assert pr.SLO_TIERS == rr.SLO_TIERS
    assert dataclasses.asdict(pr.ServiceModel()) == dataclasses.asdict(rr.ServiceModel())
    assert dataclasses.asdict(pr.SchedulerConfig()) == dataclasses.asdict(rr.SchedulerConfig())
    assert dataclasses.asdict(pr.FeedbackConfig()) == dataclasses.asdict(rr.FeedbackConfig())
