"""The port's multi-tenant fleet (``repro_torch.fleet``) against the JAX
package's, on the CPU.

One 4,000-row arxiv fixture, split into two tenants of 2,000 rows (the
same arrays in both packages; each package its own predicates from its own
``gen_queries``).  Tenant engines are unfitted, so both packages plan
alike, and the port's tenants carry the reference's global and per-shard
IVF layouts at creation.

Held equal to the reference: schema validation, token buckets and
admission, and a fleet run's batches, rejects, scale events and plans, with
exact-plan ids up to ties (an autoscale reshard rebuilds shard IVFs with
each package's own k-means, so post rows are held to their predicates).
Held within the port: DRR weights and draining, bit-identical replay,
exactness through a dead-shard recovery, and ``save``/``restore``.
"""
import numpy as np
import pytest

import repro.fleet as rf
import repro.runtime as rr
from repro.core import EngineConfig as RefConfig
from repro.core import trainer as ref_trainer
from repro_torch import carry
from repro_torch.ckpt import Checkpointer
from repro_torch.core import EngineConfig, gen_queries
from repro_torch.data import make_dataset
import repro_torch.fleet as pf
import repro_torch.runtime as pr
from repro_torch.runtime.queue import RequestQueue
from test_torch_engine import _same_up_to_ties

K = 10
TENANTS = [("alpha", "interactive", 2.0, 1), ("beta", "standard", 1.0, 2)]


def _split(ds, t):
    rows = slice(0, 2000) if t == 0 else slice(2000, 4000)
    return ds.vectors[rows], ds.cat[rows], ds.num[rows]


def _schema(mod, name, tier, weight, n_shards, dim):
    return mod.CollectionSchema(name=name, dim=dim, slo_tier=tier, weight=weight,
                                n_shards=n_shards)


def _fleets(ds, total_shards=6):
    """A reference fleet and the port's over the same tenant corpora, the
    port's engines and shards on the reference's IVF layouts."""
    fleet, rfleet = pf.Fleet(total_shards=total_shards), rf.Fleet(total_shards=total_shards)
    for t, (name, tier, weight, n_shards) in enumerate(TENANTS):
        v, c, m = _split(ds, t)
        rcol = rfleet.create(_schema(rf, name, tier, weight, n_shards, v.shape[1]), v, c, m,
                             config=RefConfig(n_lists=16, seed=0))
        col = fleet.create(_schema(pf, name, tier, weight, n_shards, v.shape[1]), v, c, m,
                           config=EngineConfig(n_lists=16, seed=0, device="cpu"))
        carry.install(col.engine, centroids=rcol.engine.ivf.centroids,
                      assignment=carry.ivf_assignment(rcol.engine.ivf))
        carry.install_shard_ivfs(col.backend.shards, carry.shard_ivf_layouts(rcol.backend.shards))
    return fleet, rfleet


@pytest.fixture(scope="module")
def system():
    ds = make_dataset("arxiv", "4000", seed=0)
    fleet, rfleet = _fleets(ds)
    data = {}
    for t, (name, *_rest) in enumerate(TENANTS):
        v, c, m = _split(ds, t)
        qs, preds, _ = gen_queries(v, c, m, 8, kinds=ds.filter_kinds,
                                   sel_range=(0.01, 0.4), seed=t + 1)
        _, rpreds, _ = ref_trainer.gen_queries(v, c, m, 8, kinds=ds.filter_kinds,
                                               sel_range=(0.01, 0.4), seed=t + 1)
        data[name] = (qs, list(preds), list(rpreds))
    return ds, fleet, rfleet, data


def _specs(data, n=120, rates=(1500.0, 1500.0), kinds=("poisson", "bursty")):
    specs, rspecs = [], []
    for (name, (qs, preds, rpreds)), rate, kind in zip(data.items(), rates, kinds):
        specs.append(pr.TenantTraceSpec(name, qs, preds, n, rate, kind=kind, k=K))
        rspecs.append(rr.TenantTraceSpec(name, qs, rpreds, n, rate, kind=kind, k=K))
    return specs, rspecs


def _sig(plan):
    return (plan.merge, plan.est, [(c.decision, c.route, c.backend, c.knob) for c in plan.clauses])


def _assert_matches_flat(fleet, req, res):
    """Exact plans merge bit-identical to the tenant's flat engine; post
    rows probe per-shard candidates, so every id must pass the predicate."""
    eng = fleet[req.tenant].engine
    if res.decision in (0, 2):
        flat = eng.query(req.query, req.pred, k=req.k)
        np.testing.assert_array_equal(res.result.ids[0], flat.result.ids[0])
    else:
        ids = res.result.ids[res.result.ids >= 0]
        if ids.size:
            cat, num = eng.live.row_attrs(ids)
            assert req.pred.eval(cat, num).all()


# ----------------------------------------------------------------------
# schemas and the registry
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(name="", dim=8), dict(name="x", dim=0),
                                dict(name="x", dim=8, slo_tier="platinum"),
                                dict(name="x", dim=8, weight=0.0),
                                dict(name="x", dim=8, n_shards=0)])
def test_schema_validation_equals_reference(kw):
    for mod in (pf, rf):
        with pytest.raises(ValueError):
            mod.CollectionSchema(**kw)
    with pytest.raises(ValueError):
        pf.FieldSpec("f", "geo")


def test_schema_from_dict_equals_reference():
    d = {"index": {"name": "products", "slo_tier": "interactive", "weight": 2.0},
         "fields": [{"name": "embedding", "type": "vector", "attrs": {"dims": 64}},
                    {"name": "brand", "type": "tag"}, {"name": "price", "type": "numeric"}]}
    s, rs = pf.CollectionSchema.from_dict(d), rf.CollectionSchema.from_dict(d)
    assert (s.name, s.dim, s.tag_fields, s.numeric_fields, s.slo_tier, s.weight, s.deadline) == \
        (rs.name, rs.dim, rs.tag_fields, rs.numeric_fields, rs.slo_tier, rs.weight, rs.deadline)
    assert s.tag_fields == ("brand",) and s.numeric_fields == ("price",)


def test_schema_rejects_mismatched_corpus(system):
    ds = system[0]
    v, c, m = _split(ds, 0)
    with pytest.raises(ValueError):
        pf.CollectionSchema(name="x", dim=v.shape[1] + 1).validate_rows(v, c, m)
    bad = pf.CollectionSchema(name="x", dim=v.shape[1], fields=tuple(
        pf.FieldSpec(f"t{i}", "tag") for i in range(c.shape[1] + 2)))
    with pytest.raises(ValueError):
        bad.validate_rows(v, c, m)


def test_fleet_registry_and_budget(system):
    ds, fleet, _, _ = system
    assert fleet.names() == ["alpha", "beta"] and "alpha" in fleet and len(fleet) == 2
    assert fleet.shards_in_use == 3
    v, c, m = _split(ds, 0)
    with pytest.raises(ValueError):
        fleet.create(pf.CollectionSchema(name="alpha", dim=v.shape[1]), v, c, m)
    with pytest.raises(ValueError):
        fleet.create(pf.CollectionSchema(name="gamma", dim=v.shape[1], n_shards=4), v, c, m,
                     config=EngineConfig(n_lists=16, seed=0, device="cpu"))
    assert fleet["alpha"].engine.device.type == "cpu"
    assert set(fleet["beta"].stats()) == {*fleet["beta"].backend.stats(), "schema"}


# ----------------------------------------------------------------------
# admission
# ----------------------------------------------------------------------
def test_token_bucket_equals_reference():
    b, rb = pf.TokenBucket(rate=10.0, burst=2.0), rf.TokenBucket(rate=10.0, burst=2.0)
    times = [0.0, 0.0, 0.0, 0.1, 0.1, 0.25, 0.3, 0.3, 0.31, 1.0, 1.0, 1.0]
    out = [b.try_take(t) for t in times]
    assert out == [rb.try_take(t) for t in times]
    assert out[:5] == [True, True, False, True, False]
    with pytest.raises(ValueError):
        pf.TokenBucket(rate=0.0, burst=1.0)


def test_admission_equals_reference(system):
    _, fleet, rfleet, data = system
    budgets = {"alpha": (800.0, 4.0)}
    ctrl, rctrl = pf.AdmissionController(budgets), rf.AdmissionController(budgets)
    specs, rspecs = _specs(data, n=150, rates=(2500.0, 900.0))
    t, rt = pr.multi_tenant_trace(specs, seed=3), rr.multi_tenant_trace(rspecs, seed=3)
    out = [ctrl.admit(r) for r in t]
    assert out == [rctrl.admit(r) for r in rt]
    assert not all(out) and any(out)
    assert ctrl.counters() == rctrl.counters()
    ctrl.reset()
    assert [ctrl.admit(r) for r in t] == out
    w = pr.RuntimeRequest(rid=1, t_arrival=0.0, query=None, pred=None, k=K, op="upsert",
                          payload=(None,), tenant="alpha")
    assert all(ctrl.admit(w) for _ in range(20))
    a = pf.AdmissionController.for_fleet(fleet, default_rate=100.0)
    ra = rf.AdmissionController.for_fleet(rfleet, default_rate=100.0)
    assert {n: (b.rate, b.burst) for n, b in a.buckets.items()} == \
        {n: (b.rate, b.burst) for n, b in ra.buckets.items()}


# ----------------------------------------------------------------------
# fair-share batching
# ----------------------------------------------------------------------
def test_drr_honours_weights_and_drains(system):
    _, fleet, _, data = system
    rt = pf.FleetRuntime(fleet)
    queues = {n: RequestQueue() for n in fleet.names()}
    for name in fleet.names():
        qs, preds, _ = data[name]
        for i in range(100):
            queues[name].push(pr.RuntimeRequest(
                rid=i if name == "alpha" else 1000 + i, t_arrival=0.0,
                query=qs[i % len(qs)], pred=preds[i % len(preds)], k=K, tenant=name))
    batch = rt._drr_batch(queues, {n: 0.0 for n in fleet.names()}, 30)
    assert len(batch) == 30
    assert sum(r.tenant == "alpha" for r in batch) == 20
    queues = {n: RequestQueue() for n in fleet.names()}
    qs, preds, _ = data["beta"]
    for i in range(10):
        queues["beta"].push(pr.RuntimeRequest(rid=i, t_arrival=0.0, query=qs[0], pred=preds[0],
                                              k=K, tenant="beta"))
    assert len(rt._drr_batch(queues, {n: 0.0 for n in fleet.names()}, 32)) == 10


# ----------------------------------------------------------------------
# fleet runs
# ----------------------------------------------------------------------
AUTOSCALE = dict(eval_every=0.02, cooldown=0.05, min_window=8)
ADMIT = dict(default_rate=1500.0, default_burst=8.0)


@pytest.mark.parametrize("fair", [True, False])
def test_fleet_run_equals_reference(system, fair):
    """Admission + DRR (or the shared baseline) + autoscaling: batches,
    rejects, scale events and plans equal the reference's; exact ids up to
    ties; every row exact against its tenant's flat engine."""
    _, fleet, rfleet, data = system
    specs, rspecs = _specs(data, n=150, rates=(2500.0, 2500.0))
    t, rt = pr.multi_tenant_trace(specs, seed=11), rr.multi_tenant_trace(rspecs, seed=11)
    rep = pf.FleetRuntime(fleet, pf.FleetConfig(max_batch=32, fair=fair),
                          admission=pf.AdmissionController.for_fleet(fleet, **ADMIT),
                          autoscale=pf.AutoscaleConfig(**AUTOSCALE)).run_trace(t)
    rrep = rf.FleetRuntime(rfleet, rf.FleetConfig(max_batch=32, fair=fair),
                           admission=rf.AdmissionController.for_fleet(rfleet, **ADMIT),
                           autoscale=rf.AutoscaleConfig(**AUTOSCALE)).run_trace(rt)
    assert rep.batches == rrep.batches
    assert rep.rejected == rrep.rejected and rep.rejected
    assert [e.as_dict() for e in rep.scale_events] == [e.as_dict() for e in rrep.scale_events]
    assert rep.scale_events
    by_rid = {r.rid: r for r in t}
    for rid, res in rep.results.items():
        x = rrep.results[rid]
        assert _sig(res.plan) == _sig(x.plan)
        if res.decision in (0, 2):
            _same_up_to_ties(by_rid[rid].query, res.result.ids, res.result.dists,
                             x.result.ids, x.result.dists)
        _assert_matches_flat(fleet, by_rid[rid], res)
    c, rc_ = rep.telemetry.counters(), rrep.telemetry.counters()
    assert c["rejects"] == rc_["rejects"] and c["slo_hit_rate"] == rc_["slo_hit_rate"]
    for name in fleet.names():
        for key in ("n_completed", "plan_counts", "batch_sizes", "deadline_met",
                    "deadline_missed", "deadline_flushes"):
            assert c["tenants"][name][key] == rc_["tenants"][name][key], (name, key)
    fleet.reset_shards()
    rfleet.reset_shards()


def test_fleet_replay_bit_identical(system):
    _, fleet, _, data = system
    specs, _ = _specs(data, n=150, rates=(2500.0, 2500.0))
    trace = pr.multi_tenant_trace(specs, seed=12)
    rt = pf.FleetRuntime(fleet, pf.FleetConfig(max_batch=32),
                         admission=pf.AdmissionController.for_fleet(fleet, default_rate=2000.0),
                         autoscale=pf.AutoscaleConfig(**AUTOSCALE))
    r1, r2 = rt.run_trace(trace), rt.run_trace(trace)
    assert r1.batches == r2.batches and r1.rejected == r2.rejected
    assert r1.telemetry.counters() == r2.telemetry.counters()
    assert [e.as_dict() for e in r1.scale_events] == [e.as_dict() for e in r2.scale_events]
    for rid in r1.results:
        np.testing.assert_array_equal(r1.ids(rid), r2.ids(rid))
    fleet.reset_shards()


def test_dead_shard_recovery_keeps_results_exact(system):
    _, fleet, rfleet, data = system
    qs, preds, rpreds = data["beta"]
    trace = pr.multi_tenant_trace([pr.TenantTraceSpec("beta", qs, preds, 200, 2000.0, k=K)],
                                  seed=29)
    rtrace = rr.multi_tenant_trace([rr.TenantTraceSpec("beta", qs, rpreds, 200, 2000.0, k=K)],
                                   seed=29)
    t_mid = trace.requests[100].t_arrival
    cfg = dict(eval_every=0.02, cooldown=0.0, min_window=10**9, heartbeat_timeout=0.02)
    rep = pf.FleetRuntime(fleet, pf.FleetConfig(max_batch=32),
                          autoscale=pf.AutoscaleConfig(**cfg),
                          faults=[pf.FaultInjection(t=t_mid, tenant="beta", shard=1)]
                          ).run_trace(trace)
    rrep = rf.FleetRuntime(rfleet, rf.FleetConfig(max_batch=32),
                           autoscale=rf.AutoscaleConfig(**cfg),
                           faults=[rf.FaultInjection(t=t_mid, tenant="beta", shard=1)]
                           ).run_trace(rtrace)
    rec = [e for e in rep.scale_events if e.action == "recover"]
    assert rec and rec[0].tenant == "beta" and rec[0].to_shards == rec[0].from_shards - 1
    assert rec[0].mesh == (rec[0].to_shards, 1) and rec[0].t > t_mid
    assert [e.as_dict() for e in rep.scale_events] == [e.as_dict() for e in rrep.scale_events]
    by_rid = {r.rid: r for r in trace}
    for rid, res in rep.results.items():
        _assert_matches_flat(fleet, by_rid[rid], res)
    fleet.reset_shards()
    rfleet.reset_shards()


def test_fleet_save_restore(system, tmp_path):
    """A mutated tenant's state and shard assignment restore onto freshly
    built collections: exact rows equal bitwise; the manifest equals the
    reference's for the same writes."""
    ds = system[0]
    fleet, rfleet = _fleets(ds, total_shards=4)
    for f in (fleet, rfleet):
        v, c, m = _split(ds, 0)
        gids = f["alpha"].upsert(v[:5] + 0.01, c[:5], m[:5])
        f["alpha"].delete(np.asarray([1, 2, int(gids[0])]))
        f["beta"].reshard(1)
    assert fleet.manifest() == rfleet.manifest()
    ck = Checkpointer(str(tmp_path), keep=2)
    fleet.save(ck, step=7)
    meta = ck.latest_meta()["fleet"]
    assert meta["tenants"]["beta"]["n_shards"] == 1
    assert meta["tenants"]["alpha"]["corpus_generation"] > 0 == \
        meta["tenants"]["beta"]["corpus_generation"]
    fresh, _ = _fleets(ds, total_shards=4)
    fresh.restore(ck)
    assert fresh.manifest()["tenants"]["alpha"]["live_count"] == \
        fleet.manifest()["tenants"]["alpha"]["live_count"]
    assert fresh["beta"].n_shards == 1
    for name, (qs, preds, _) in system[3].items():
        for q, p in zip(qs, preds):
            a, b = fleet[name].query(q, p, k=K), fresh[name].query(q, p, k=K)
            if a.decision in (0, 2):
                np.testing.assert_array_equal(a.result.ids, b.result.ids)
                np.testing.assert_array_equal(a.result.dists, b.result.dists)
    other = pf.Fleet(total_shards=4)
    v, c, m = _split(ds, 1)
    other.create(pf.CollectionSchema(name="zz", dim=v.shape[1]), v, c, m,
                 config=EngineConfig(n_lists=16, seed=0, device="cpu"))
    with pytest.raises(ValueError):
        other.restore(ck)
