"""The port's observability (``repro_torch.obs``) and the engine hooks it
reads, against the JAX package's, on the CPU.

One 4,000-row arxiv fixture; both packages get the same arrays, each its
own predicates from its own ``gen_queries``, and the port carries the
reference's IVF layout (the engines are unfitted, so plans agree).

Held equal to the reference: registry values, series and snapshots, the
Prometheus exposition byte for byte, ``publish_stats``, the deterministic
span tree of a traced cold replay (plain, DNF and live traffic, a
compaction included), its JSONL export apart from wall clock, the keys of
``stats()``, and probe sampling and estimates.  The span trees differ only
where ``SPAN_EXCEPTIONS`` says, each documented in ROADMAP.md.  The kernel
budget gauges are the port's own: shared memory per block, not VMEM.
"""
import json

import numpy as np
import pytest

import repro.obs as ro
import repro.runtime as rr
from repro.core import EngineConfig as RefConfig
from repro.core import FilteredANNEngine as RefEngine
from repro.core import Or as RefOr
from repro.core import trainer as ref_trainer
from repro.fleet.telemetry import FleetTelemetry as RefFleetTelemetry
from repro_torch import carry
from repro_torch.core import EngineConfig, FilteredANNEngine, Or, gen_queries
from repro_torch.data import make_dataset
from repro_torch.fleet.telemetry import FleetTelemetry
from repro_torch.kernels import ops
from repro_torch.kernels.masked_l2 import KPAD, SMEM_MAX, smem_bytes
import repro_torch.obs as po
import repro_torch.runtime as pr

K = 10
CFG = dict(max_batch=16, max_wait=0.004)
# Where the port's span tree differs from the reference's, by design (each
# listed in ROADMAP.md, "Documented differences"), and the attr it touches;
# the tests below show each difference and that nothing else differs.
SPAN_EXCEPTIONS = {
    # k > 128 is beyond the kernel's lists: the port runs l2_topk and
    # records it under its own name; the reference records every call as
    # fused_masked_topk
    "k_above_kpad": "kernel_fused_masked_topk_l2_topk",
    # the port's flat backend scans with fused_masked_topk (the kernel on
    # the card) and records it; the reference's scans with an unrecorded
    # l2_topk, so routed flat:exact groups count only in the port
    "routed_flat": "kernel_fused_masked_topk",
    # after a compaction each package's post rows run on its own rebuilt
    # IVF (its own k-means), so the post groups' expansion rounds may differ
    "after_compaction": "expansion_rounds",
    # a sharded single conjunctive query() fans out through the batch path
    # in the port (shard and group spans under shard_fanout); the
    # reference's per-shard search opens none
    "sharded_query": "shard",
}


def _pair(ds, **cfg):
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
    preds = list(preds) + [Or((preds[0], preds[1])), Or((preds[2], preds[3], preds[0]))]
    rpreds = list(rpreds) + [RefOr((rpreds[0], rpreds[1])),
                             RefOr((rpreds[2], rpreds[3], rpreds[0]))]
    return ds, port, ref, qs, preds, rpreds


def _traces(system, n=80, seed=5, **kw):
    _, _, _, qs, preds, rpreds = system
    return (pr.poisson_trace(qs, preds, n, 3000.0, k=K, seed=seed, **kw),
            rr.poisson_trace(qs, rpreds, n, 3000.0, k=K, seed=seed, **kw))


def _traced_run(eng, trace, runtime, tracer, probe=None):
    """One traced replay from a cold cache state (cache-delta attrs depend
    on cache contents)."""
    eng.plan_cache.clear()
    eng.pred_cache.clear()
    rep = runtime.OnlineRuntime(eng, runtime.SchedulerConfig(**CFG), tracer=tracer,
                                probe=probe).run_trace(trace)
    eng.set_tracer(None)
    return tracer, rep


def _strip(tree, drop=(), where=lambda n: True):
    """A deterministic tree without the attrs named in ``drop`` on the
    spans ``where`` selects (every span by default)."""
    return [{**n, "attrs": {k: v for k, v in n["attrs"].items() if not (k in drop and where(n))},
             "children": _strip(n["children"], drop, where)} for n in tree]


def _nodes(tree):
    for n in tree:
        yield n
        yield from _nodes(n["children"])


def _shape(tree, drop_children_of=None):
    """Names, attrs and nesting without span ids; the children of spans
    named ``drop_children_of`` removed."""
    return [{"name": n["name"], "attrs": n["attrs"],
             "children": [] if n["name"] == drop_children_of
             else _shape(n["children"], drop_children_of)} for n in tree]


# ----------------------------------------------------------------------
# the registry, against the reference's
# ----------------------------------------------------------------------
def _fill(reg):
    reg.inc("req_total", 0)
    reg.inc("req_total")
    reg.inc("req_total", 2, help="served requests")
    reg.inc("plan_total", plan="pre")
    reg.inc("plan_total", plan="post", tenant="a")
    reg.inc("plan_total", tenant="a", plan="post")
    reg.set_gauge("depth", 7.5)
    reg.set_gauge("depth", 3, tenant='we"ird\\')
    for v in (0.002, 0.2, 1e-5, 7.0):
        reg.observe("lat_seconds", v, tier="std")
    reg.observe("small_seconds", 0.002, buckets=(1e-3, 1e-2), tier="std")
    return reg


def test_registry_equals_reference():
    reg, ref = _fill(po.MetricsRegistry()), _fill(ro.MetricsRegistry())
    assert reg.value("req_total") == 3 == ref.value("req_total")
    assert reg.value("plan_total", plan="post", tenant="a") == 2
    assert reg.series("plan_total", match={"tenant": "a"}) == \
        ref.series("plan_total", match={"tenant": "a"}) == [({"plan": "post", "tenant": "a"}, 2)]
    assert reg.snapshot() == ref.snapshot()
    assert reg.prometheus_text() == ref.prometheus_text()
    with pytest.raises(ValueError):
        reg.inc("req_total", -1)
    with pytest.raises(ValueError):
        reg.set_gauge("req_total", 5)


def test_registry_prometheus_golden():
    reg = po.MetricsRegistry()
    reg.inc("repro_requests_total", 3, help="served requests")
    reg.inc("repro_plan_total", 2, plan="ipre")
    reg.inc("repro_plan_total", 1, plan="post")
    reg.observe("repro_lat_seconds", 0.002, buckets=(1e-3, 1e-2), tier="std")
    reg.observe("repro_lat_seconds", 0.2, buckets=(1e-3, 1e-2), tier="std")
    assert reg.prometheus_text() == (
        "# TYPE repro_lat_seconds histogram\n"
        'repro_lat_seconds_bucket{tier="std",le="0.001"} 0\n'
        'repro_lat_seconds_bucket{tier="std",le="0.01"} 1\n'
        'repro_lat_seconds_bucket{tier="std",le="+Inf"} 2\n'
        'repro_lat_seconds_sum{tier="std"} 0.202\n'
        'repro_lat_seconds_count{tier="std"} 2\n'
        "# TYPE repro_plan_total counter\n"
        'repro_plan_total{plan="ipre"} 2\n'
        'repro_plan_total{plan="post"} 1\n'
        "# HELP repro_requests_total served requests\n"
        "# TYPE repro_requests_total counter\n"
        "repro_requests_total 3\n"
    )


def test_publish_stats_equals_reference(system):
    _, port, ref, *_ = system
    stats = {"pred_cache": {"hits": 4, "ratio": 0.5}, "name": "skipped", "ok": True}
    a, b = po.MetricsRegistry(), ro.MetricsRegistry()
    po.publish_stats(a, stats, prefix="repro_engine", tenant="t")
    ro.publish_stats(b, stats, prefix="repro_engine", tenant="t")
    assert a.prometheus_text() == b.prometheus_text()
    assert a.value("repro_engine_ok", tenant="t") == 1
    assert a.series("repro_engine_name") == []
    # the engines' own stats publish under the same names
    a, b = po.MetricsRegistry(), ro.MetricsRegistry()
    s, rs = port.stats(), ref.stats()
    s.pop("kernel_dispatch"), rs.pop("kernel_dispatch")
    po.publish_stats(a, s)
    ro.publish_stats(b, rs)
    assert [n for n in a.snapshot()] == [n for n in b.snapshot()]


def test_kernel_smem_budget_gauges():
    reg = po.MetricsRegistry()
    po.publish_kernel_budget(reg)
    for d in (128, 256, 512):
        k = f"masked_l2_d{d}"
        for qt in (1, 8, 32, 64):
            smem = reg.value("repro_kernel_smem_bytes", kernel=k, qt=qt)
            assert smem == smem_bytes(qt, d, KPAD) > 0
            assert reg.value("repro_kernel_smem_fits_sm90", kernel=k, qt=qt) == int(smem <= SMEM_MAX)
        assert reg.value("repro_kernel_smem_fits_sm90", kernel=k, qt=1) == 1
        assert reg.value("repro_kernel_smem_fits_sm90", kernel=k, qt=32) == 1
    assert "vmem" not in reg.prometheus_text().lower()


def test_fleet_registry_shared_with_tenant_labels():
    for ft in (FleetTelemetry(), RefFleetTelemetry()):
        ta, tb = ft.tenant("a"), ft.tenant("b")
        assert ta.registry is ft.registry is tb.registry
        ta._inc("repro_requests_total", 5)
        tb._inc("repro_requests_total", 2)
        assert ta.n_completed == 5 and tb.n_completed == 2
        ft.record_reject("b")
        assert ft.rejects == {"b": 1}
    assert FleetTelemetry().registry.prometheus_text() == RefFleetTelemetry().registry.prometheus_text()


def test_telemetry_registry_equals_reference(system):
    _, port, ref, *_ = system
    t, rt = _traces(system, n=60)
    rep = pr.OnlineRuntime(port, pr.SchedulerConfig(**CFG)).run_trace(t)
    rrep = rr.OnlineRuntime(ref, rr.SchedulerConfig(**CFG)).run_trace(rt)
    tel = rep.telemetry
    assert tel.counters()["n_completed"] == 60 == tel.registry.value("repro_requests_total")
    assert tel.registry.prometheus_text() == rrep.telemetry.registry.prometheus_text()
    assert tel.registry.snapshot() == rrep.telemetry.registry.snapshot()


# ----------------------------------------------------------------------
# tracing
# ----------------------------------------------------------------------
def test_null_tracer_is_inert():
    with po.NULL_TRACER.span("anything", x=1):
        po.NULL_TRACER.annotate(y=2)
        po.NULL_TRACER.add_wall("k", 0.5)
    assert not po.NULL_TRACER.enabled
    assert list(po.NULL_TRACER.spans()) == []


def test_span_tree_equals_reference(system):
    """Plain and DNF traffic: the port's deterministic tree equals the
    reference's, and a replay equals it again; the tree has every stage."""
    _, port, ref, *_ = system
    t, rt = _traces(system, n=80)
    a, rep = _traced_run(port, t, pr, po.Tracer())
    b, _ = _traced_run(ref, rt, rr, ro.Tracer())
    again, _ = _traced_run(port, t, pr, po.Tracer())
    assert a.deterministic_tree() == again.deterministic_tree()
    assert a.deterministic_tree() == b.deterministic_tree()
    names = {s.name for s in a.spans()}
    assert {"batch", "plan", "predicate_compile", "execute", "group"} <= names
    assert all(s.name == "batch" for s in a.roots)
    groups = [s for s in a.spans() if s.name == "group"]
    assert all({"decision", "backend", "knob", "n_rows"} <= set(g.attrs) for g in groups)
    assert any("n_candidates" in g.attrs for g in groups)
    execs = [s for s in a.spans() if s.name == "execute"]
    assert all(any(k.startswith("kernel_") for k in e.attrs) for e in execs)
    assert sum(s.wall_s for s in a.spans()) > 0.0
    # the execute spans' dispatch attrs sum to the ledger's delta
    ops.reset_dispatch_stats()
    c, _ = _traced_run(port, t, pr, po.Tracer())
    total = sum(s.attrs.get("kernel_fused_masked_topk", 0) for s in c.spans()
                if s.name == "execute")
    assert total == ops.dispatch_counts()["fused_masked_topk"] > 0


def test_single_query_and_clause_spans_equal_reference(system):
    """``query()`` (conjunctions and a union: ``plan`` with its ``clause``
    spans, ``execute``) traces as the reference's does."""
    _, port, ref, qs, preds, rpreds = system
    trees = []
    for eng, ps, tracer in ((port, preds, po.Tracer()), (ref, rpreds, ro.Tracer())):
        eng.plan_cache.clear()
        eng.pred_cache.clear()
        eng.set_tracer(tracer)
        for i in (0, 3, 16, 17, 16):
            eng.query(qs[i % len(qs)], ps[i], K)
        eng.explain(ps[17], K)
        eng.set_tracer(None)
        trees.append(tracer)
    assert trees[0].deterministic_tree() == trees[1].deterministic_tree()
    assert sum(s.name == "clause" for s in trees[0].spans()) == 5


def test_live_span_tree_equals_reference(system):
    """Writes, a compaction and reads on a mutated corpus: the same tree."""
    ds = system[0]
    port, ref = _pair(ds, max_tombstone_frac=0.004)
    wc = (ds.vectors[:40] + 0.01, ds.cat[:40], ds.num[:40])
    t, rt = _traces(system, n=200, seed=13, write_frac=0.25, write_corpus=wc,
                    delete_pool=np.arange(0, 4000, 97))
    a, _ = _traced_run(port, t, pr, po.Tracer())
    b, _ = _traced_run(ref, rt, rr, ro.Tracer())
    names = {s.name for s in a.spans()}
    assert {"write", "compact"} <= names
    assert any(s.attrs.get("live") for s in a.spans() if s.name == "group")
    # the exception holds only for group spans opened after the first
    # compaction: before it both packages search the same carried IVF
    compact = min(s.span_id for s in a.spans() if s.name == "compact")
    assert compact == min(s.span_id for s in b.spans() if s.name == "compact")
    key = SPAN_EXCEPTIONS["after_compaction"]
    assert any(key in n["attrs"] and n["span_id"] < compact
               for n in _nodes(a.deterministic_tree()) if n["name"] == "group")

    def after(n):
        return n["name"] == "group" and n["span_id"] > compact

    assert _strip(a.deterministic_tree(), (key,), after) == \
        _strip(b.deterministic_tree(), (key,), after)


def test_span_exception_k_above_kpad(system):
    """At k = 130 the port's execute spans count the groups whose k stays
    above 128 as ``kernel_fused_masked_topk_l2_topk`` (the others keep
    the kernel); folded into ``kernel_fused_masked_topk``, the trees are
    equal."""
    _, port, ref, qs, preds, rpreds = system
    trees = []
    for eng, ps, tracer in ((port, preds, po.Tracer()), (ref, rpreds, ro.Tracer())):
        eng.plan_cache.clear()
        eng.pred_cache.clear()
        eng.set_tracer(tracer)
        eng.batch_query(qs[:8], ps[:8], 130)
        eng.set_tracer(None)
        trees.append(tracer.deterministic_tree())
    key = SPAN_EXCEPTIONS["k_above_kpad"]

    def rename(tree):
        out = []
        for n in tree:
            attrs = {k: v for k, v in n["attrs"].items() if k != key}
            if key in n["attrs"]:
                attrs["kernel_fused_masked_topk"] = (attrs.get("kernel_fused_masked_topk", 0)
                                                     + n["attrs"][key])
            out.append({**n, "attrs": attrs, "children": rename(n["children"])})
        return out

    assert trees[0] != trees[1]
    assert rename(trees[0]) == trees[1]


def test_span_exception_sharded_query(system):
    """A sharded single query(): the port's shard_fanout holds shard and
    group spans the reference's does not; the rest of the tree is equal."""
    from repro.serve import ShardedANNEngine as RefSharded
    from repro_torch.serve import ShardedANNEngine

    _, port, ref, qs, preds, rpreds = system
    sh, rsh = ShardedANNEngine(port, n_shards=2), RefSharded(ref, n_shards=2)
    carry.install_shard_ivfs(sh.shards, carry.shard_ivf_layouts(rsh.shards))
    trees = []
    for eng, e, ps, tracer in ((sh, port, preds, po.Tracer()), (rsh, ref, rpreds, ro.Tracer())):
        e.plan_cache.clear()
        e.pred_cache.clear()
        eng.set_tracer(tracer)
        for i in (0, 1, 16):
            eng.query(qs[i % len(qs)], ps[i], K)
        eng.batch_query(qs[:6], ps[:6], K)
        eng.set_tracer(None)
        trees.append(tracer)
    a, b = trees
    assert any(s.name == SPAN_EXCEPTIONS["sharded_query"] for s in a.spans())
    assert _shape(a.deterministic_tree(), "shard_fanout") == \
        _shape(b.deterministic_tree(), "shard_fanout")
    # the batch path (and a union's single query) fans out alike in both
    batch = [n for n in a.deterministic_tree() if n["name"] == "shard_fanout"]
    rbatch = [n for n in b.deterministic_tree() if n["name"] == "shard_fanout"]
    assert _shape(batch[-2:]) == _shape(rbatch[-2:])


def test_span_exception_routed_flat(system):
    """A routed engine: the port's execute spans also count the flat
    backend's fused_masked_topk dispatches; without that attr the trees
    are equal."""
    from test_torch_engine import _threshold_head

    ds, _, _, qs, preds, rpreds = system
    port, ref = _pair(ds, backends=("flat", "ivf"))
    conj = [p for p in preds if not isinstance(p, Or)]
    rconj = [p for p in rpreds if not isinstance(p, RefOr)]
    ref.planner.load_state(_threshold_head(0.05))
    ses = [ref.estimator.estimate(p) for p in rconj]
    feats = np.stack([ref.feat.vector(p, se.sel, K, se.is_exact) for p, se in zip(rconj, ses)])
    names = ref.backend_set.class_names()
    # the plan head's post rows, by selectivity, spread over every class
    sels = np.asarray([se.sel for se in ses])
    post = np.flatnonzero(sels > 0.05)
    labels = np.full(len(rconj), -1, np.int64)
    labels[post[np.argsort(sels[post], kind="stable")]] = np.arange(post.size) * len(names) // post.size
    ref.planner.fit_routing(feats, labels, names)
    rb = ref.backend_set.backends
    carry.install(port, planner=ref.planner.state_dict(),
                  backend_ivf=(rb["ivf"].index.centroids, carry.ivf_assignment(rb["ivf"].index)))
    t = pr.poisson_trace(qs, conj, 60, 3000.0, k=K, seed=21)
    rt = rr.poisson_trace(qs, rconj, 60, 3000.0, k=K, seed=21)
    a, _ = _traced_run(port, t, pr, po.Tracer())
    b, _ = _traced_run(ref, rt, rr, ro.Tracer())
    assert any(s.attrs.get("backend") == "flat" and s.attrs.get("decision") == "post"
               for s in a.spans() if s.name == "group")
    assert a.deterministic_tree() != b.deterministic_tree()
    key = SPAN_EXCEPTIONS["routed_flat"]

    def routed_flat(n):
        # an execute span that holds a routed flat group
        return n["name"] == "execute" and any(
            c["name"] == "group" and c["attrs"].get("decision") == "post"
            and c["attrs"].get("backend") == "flat" for c in n["children"])

    # the exception holds only there: the other execute spans keep the attr
    # and compare exactly, and where it is dropped the port counts more
    assert any(key in n["attrs"] and not routed_flat(n) for n in _nodes(a.deterministic_tree()))
    for n, m in zip(_nodes(a.deterministic_tree()), _nodes(b.deterministic_tree())):
        if routed_flat(n):
            assert n["attrs"].get(key, 0) > m["attrs"].get(key, 0)
    assert _strip(a.deterministic_tree(), (key,), routed_flat) == \
        _strip(b.deterministic_tree(), (key,), routed_flat)


def test_span_summary_ordering(system):
    _, port, *_ = system
    tracer, _ = _traced_run(port, _traces(system, n=40)[0], pr, po.Tracer())
    rows = po.span_summary(tracer)
    assert [r["stage"] for r in rows] == [r["stage"] for r in tracer.span_summary()]
    stages = [r["stage"] for r in rows]
    assert {"batch", "plan", "execute", "group"} <= set(stages)
    assert any(s.startswith("kernel:") for s in stages)
    assert all(r["self_s"] <= r["wall_s"] + 1e-12 for r in rows)
    assert [r["self_s"] for r in rows] == sorted((r["self_s"] for r in rows), reverse=True)
    # the ranking is the reference's: the same rows for the same spans
    assert ro.span_summary(tracer) == rows


def test_trace_jsonl_export_equals_reference(system, tmp_path):
    _, port, ref, *_ = system
    t, rt = _traces(system, n=24)
    a, _ = _traced_run(port, t, pr, po.Tracer())
    b, _ = _traced_run(ref, rt, rr, ro.Tracer())
    a.write_jsonl(tmp_path / "a.jsonl")
    b.write_jsonl(tmp_path / "b.jsonl")
    rows = [json.loads(x) for x in (tmp_path / "a.jsonl").read_text().splitlines()]
    rrows = [json.loads(x) for x in (tmp_path / "b.jsonl").read_text().splitlines()]
    assert len(rows) == sum(1 for _ in a.spans())
    ids = {r["span_id"] for r in rows}
    assert all(r["parent_id"] in ids or r["parent_id"] == -1 for r in rows)
    assert all(set(r) == {"span_id", "parent_id", "name", "attrs", "wall"} for r in rows)
    assert [{k: v for k, v in r.items() if k != "wall"} for r in rows] == \
        [{k: v for k, v in r.items() if k != "wall"} for r in rrows]


# ----------------------------------------------------------------------
# engine stats
# ----------------------------------------------------------------------
def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "kernel_dispatch":
            out |= _keys(v, prefix + k + ".")
    return out


def test_engine_stats_equal_reference(system):
    _, port, ref, qs, preds, rpreds = system
    for eng in (port, ref):
        eng.plan_cache.clear()
        eng.pred_cache.clear()
    ops.reset_dispatch_stats()
    s0, rs0 = port.stats(), ref.stats()
    port.batch_query(qs[:8], preds[:8], K)
    ref.batch_query(qs[:8], rpreds[:8], K)
    s, rs = port.stats(), ref.stats()
    assert _keys(s) == _keys(rs)
    assert set(s["cache_hit_ratio"]) == {"pred_cache", "mask_tier", "plan_cache"}
    for cache in ("plan_cache", "pred_cache"):     # cumulative: compare the deltas
        for key in ("hits", "misses"):
            assert s[cache][key] - s0[cache][key] == rs[cache][key] - rs0[cache][key]
    assert s["plan_cache"]["size"] == rs["plan_cache"]["size"] and s["live"] == rs["live"]
    counts = ops.dispatch_counts()
    assert s["kernel_dispatch"] == counts and counts["fused_masked_topk"] > 0
    reg = po.MetricsRegistry()
    po.publish_kernel_dispatch(reg)
    for name, n in counts.items():
        assert reg.value("repro_kernel_dispatch_total", kernel=name) == n
        assert reg.value("repro_kernel_wall_seconds", kernel=name) >= 0.0


# ----------------------------------------------------------------------
# recall probe
# ----------------------------------------------------------------------
def test_probe_sampling_equals_reference():
    for rate, seed in ((0.3, 11), (0.05, 0), (1.0, 2), (0.0, 3)):
        p, rp = po.RecallProbe(rate=rate, seed=seed), ro.RecallProbe(rate=rate, seed=seed)
        picks = [p.should_sample(rid) for rid in range(300)]
        assert picks == [rp.should_sample(rid) for rid in range(300)]
        assert picks == [p.should_sample(rid) for rid in reversed(range(300))][::-1]
    assert 0 < sum(po.RecallProbe(rate=0.3, seed=11).should_sample(r) for r in range(300)) < 300


def test_probe_estimates_equal_reference(system):
    """The same served results and oracle give the same counters; a run
    through each package's runtime gives the same sampling and classes."""
    _, port, ref, *_ = system
    t, rt = _traces(system, n=60, seed=9)
    p, rp = po.RecallProbe(rate=0.5, seed=3), ro.RecallProbe(rate=0.5, seed=3)
    _, rep = _traced_run(port, t, pr, po.Tracer(), probe=p)
    _, rrep = _traced_run(ref, rt, rr, ro.Tracer(), probe=rp)
    c, rc_ = p.counters(), rp.counters()
    assert (c["n_seen"], c["n_sampled"]) == (rc_["n_seen"], rc_["n_sampled"])
    assert 0 < c["n_sampled"] < c["n_seen"] == 60
    assert {k: v["count"] for k, v in c["classes"].items()} == \
        {k: v["count"] for k, v in rc_["classes"].items()}
    # the same results through both probes, one oracle: equal ledgers
    truth = {(r.query.tobytes(), id(r.pred)): port.ground_truth(r.query, r.pred, K) for r in t}

    def truth_fn(q, pred, k):
        return truth[(np.asarray(q[0], np.float32).tobytes(), id(pred))]

    a = po.RecallProbe(rate=0.5, seed=3, truth_fn=truth_fn)
    b = ro.RecallProbe(rate=0.5, seed=3, truth_fn=truth_fn)
    for r in t:
        a.observe(r, rep.results[r.rid])
        b.observe(r, rep.results[r.rid])
    assert a.counters() == b.counters()
    assert a.below(1.01) == b.below(1.01)
    reg, rreg = po.MetricsRegistry(), ro.MetricsRegistry()
    a.publish(reg, tenant="x")
    b.publish(rreg, tenant="x")
    assert reg.prometheus_text() == rreg.prometheus_text()
