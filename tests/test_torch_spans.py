"""The port's own spans on the serving path, on the CPU.

One traced ``batch_query`` on a small engine whose planner head plans
exact under 45 % and ``post`` above, over a corpus drawn here from a fixed
seed (not from ``make_dataset``, whose corpus depends on the process's
string hash).  One batch holds an ``ipre`` group in each branch of the
exact scan (a label filter at about 5 %, gathered; a range at 35 %, over
the whole corpus), a ``post`` group whose rows double α at least once (its
range passes 60 % of the rows, those far along the first coordinate from
its queries), and cold range predicates.  The spans nest as the engine
opens them: ``mask``, ``h2d``, ``gather``, ``scan`` inside an exact group;
``ivf.search`` (``h2d``, ``ivf.probe``, ``ivf.scan`` with two ``h2d``) and
``post.check`` inside the post group; ``bitmap_compile`` inside
``predicate_compile``, with the rows its range leaves packed at their cuts;
``package`` a root after ``execute``.  The counters equal their hand counts,
and the results are the same bits with tracing on and off.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, FilteredANNEngine, LabelEq, Not, Or, Predicate,
                              RangePred, iter_leaves)
from repro_torch.filter import PredicateCache
from repro_torch.kernels import ops
from repro_torch.obs.trace import NULL_TRACER, Tracer

K = 10
CUT = 0.45
N, D = 2000, 32


@pytest.fixture(scope="module")
def system():
    from test_torch_engine import _threshold_head

    rng = np.random.default_rng(7)
    vectors = rng.normal(size=(N, D)).astype(np.float32)
    vectors[:, 0] *= 10.0      # the first coordinate sets the lists and the distances
    cat = np.stack([rng.integers(0, n, N) for n in (20, 10, 5)], 1).astype(np.int32)
    year = rng.uniform(2000.0, 2025.0, N).astype(np.float32)
    score = vectors[:, 0] + 50.0
    num = np.stack([year, score], 1)
    eng = FilteredANNEngine(vectors, cat, num,
                            EngineConfig(n_lists=32, seed=0, device="cpu")).build()
    eng.planner.load_state(_threshold_head(CUT))
    gathered = Predicate(labels=(LabelEq(0, 2),))
    full = Predicate(ranges=(RangePred(0, ((1999.0, float(np.quantile(year, 0.35))),)),))
    post = Predicate(ranges=(RangePred(1, ((float(np.quantile(score, 0.4)),
                                            float(score.max()) + 1.0),)),))
    preds = [gathered, full, gathered] + [post] * 8
    qs = rng.normal(size=(len(preds), D)).astype(np.float32)
    qs[3:, 0] = -40.0          # the post rows' neighbours fail their range
    return vectors, cat, num, eng, qs, preds


def _traced(eng, qs, preds, tracer):
    eng.plan_cache.clear()
    eng.pred_cache.clear()
    eng.set_tracer(tracer)
    try:
        return eng.batch_query(qs, preds, K)
    finally:
        eng.set_tracer(None)


def _names(spans):
    return [s.name for s in spans]


def test_plans_cover_every_branch(system):
    _, cat, num, eng, qs, preds = system
    out = _traced(eng, qs, preds, NULL_TRACER)
    assert [r.plan.strategy for r in out] == ["ipre"] * 3 + ["post"] * 8
    sel = [p.eval(cat, num).mean() for p in preds[:2]]
    assert sel[0] < 0.25 < sel[1] < CUT       # gathered, then the full-corpus branch
    assert any(r.result.n_expansions > 0 for r in out[3:])


def test_spans_nest_as_the_engine_opens_them(system):
    *_, eng, qs, preds = system
    tr = Tracer()
    _traced(eng, qs, preds, tr)
    assert _names(tr.roots) == ["plan", "execute", "package"]
    assert all(s.parent_id == -1 for s in tr.roots)
    plan, execute, package = tr.roots
    (compile_,) = plan.children
    assert compile_.name == "predicate_compile"
    # three distinct cold predicates, each compiled once
    assert _names(compile_.children) == ["bitmap_compile"] * 3
    assert package.children == []
    groups = execute.children
    assert [(g.name, g.attrs["decision"]) for g in groups] == \
        [("group", "ipre")] * 2 + [("group", "post")]
    assert _names(groups[0].children) == ["mask", "h2d", "gather", "scan"]
    assert _names(groups[1].children) == ["mask", "h2d", "scan"]
    post = groups[2]
    kids = _names(post.children)
    assert len(kids) >= 4 and kids == ["ivf.search", "post.check"] * (len(kids) // 2)
    for s in post.children:
        if s.name == "ivf.search":
            assert _names(s.children) == ["h2d", "ivf.probe", "ivf.scan"]
            assert _names(s.children[2].children) == ["h2d", "h2d"]
    leaves = {"mask", "gather", "scan", "h2d", "ivf.probe", "post.check", "bitmap_compile"}
    assert all(not s.children for s in tr.spans() if s.name in leaves)


def test_counters_equal_their_hand_counts(system):
    vectors, cat, num, eng, qs, preds = system
    n, d = vectors.shape
    tr = Tracer()
    out = _traced(eng, qs, preds, tr)
    _, execute, _ = tr.roots
    for g in execute.children[:2]:
        (h2d,) = [s for s in g.children if s.name == "h2d"]
        assert h2d.attrs == {"bytes": n + g.attrs["n_rows"] * d * 4}
    # the group's passing count is the mask's, as before
    masks = [p.eval(cat, num) for p in preds[:2]]
    assert [g.attrs["n_candidates"] for g in execute.children[:2]] == \
        [int(m.sum()) for m in masks]
    post = execute.children[2]
    searches = [s for s in post.children if s.name == "ivf.search"]
    for s in searches:
        assert s.children[0].attrs == {"bytes": s.attrs["n_rows"] * d * 4}
        # the candidates' int64 indices, then their int64 rows and positions
        cand, scatter = (h.attrs["bytes"] for h in s.children[2].children)
        assert cand > 0 and cand % 8 == 0 and scatter == 2 * cand
    # every post row is searched once a pass: its first and each doubling
    passes = sum(r.result.n_expansions + 1 for r in out if r.plan.strategy == "post")
    assert sum(s.attrs["n_rows"] for s in searches) == passes
    assert passes == post.attrs["n_rows"] + post.attrs["expansion_rounds"]
    # the new spans carry no other attribute
    for s in tr.spans():
        if s.name == "bitmap_compile":
            assert set(s.attrs) == {"cut_rows"}
        elif s.name not in ("plan", "predicate_compile", "execute", "group", "h2d",
                            "ivf.search"):
            assert s.attrs == {}


def _hand_cut_rows(num, pred, buckets=128):
    """The rows a predicate's range leaves pack at their cuts, from the
    column: a cut is the number of rows below its bound and costs its
    distance to the nearest edge, unless the slice has fewer rows."""
    n = num.shape[0]
    edges = np.round(np.linspace(0, n, min(buckets, n) + 1))
    total = 0
    for leaf in iter_leaves(pred):
        if isinstance(leaf, RangePred):
            x = num[:, leaf.attr]
            for lo, hi in leaf.intervals:
                left, right = int((x < lo).sum()), int((x < hi).sum())
                if right > left:
                    total += min(right - left, int(np.abs(edges - left).min())
                                 + int(np.abs(edges - right).min()))
    return total


def test_bitmap_compile_counts_its_cut_rows(system):
    _, cat, num, eng, qs, preds = system
    tr = Tracer()
    _traced(eng, qs, preds, tr)
    compiles = [s for s in tr.spans() if s.name == "bitmap_compile"]
    # the batch's cold predicates in order: a label filter, then two ranges
    got = [s.attrs["cut_rows"] for s in compiles]
    assert got == [_hand_cut_rows(num, p) for p in (preds[0], preds[1], preds[3])]
    assert got[0] == 0 and min(got[1:]) > 0
    # several range leaves, a negated one and two terms: their sum, at most
    # half a bucket a cut, and the same words untraced
    year, score = (np.quantile(num[:, j], [0.1, 0.3, 0.55, 0.8, 0.9]) for j in (0, 1))
    pred = Or((
        Predicate(ranges=(RangePred(0, ((year[0], year[1]), (year[2], year[3]))),
                          RangePred(1, ((score[0], score[4]),))),
                  nots=(Not(RangePred(1, ((score[1], score[2]),))),)),
        Predicate(labels=(LabelEq(1, 3),), ranges=(RangePred(1, ((score[3], score[4]),)),)),
    ))
    tr = Tracer()
    traced = PredicateCache().get_or_compile(pred, eng.attr_index, tracer=tr)
    plain = PredicateCache().get_or_compile(pred, eng.attr_index)
    (span,) = tr.roots
    assert span.attrs == {"cut_rows": _hand_cut_rows(num, pred)}
    bucket = max(np.diff(np.round(np.linspace(0, len(num), 129))))
    assert 0 < span.attrs["cut_rows"] <= 5 * 2 * int(np.ceil(bucket / 2))   # five intervals
    np.testing.assert_array_equal(traced.words, plain.words)
    np.testing.assert_array_equal(traced.mask(), pred.eval(cat, num))


def test_results_are_the_same_bits_traced_and_not(system):
    *_, eng, qs, preds = system
    off = _traced(eng, qs, preds, NULL_TRACER)
    on = _traced(eng, qs, preds, Tracer())
    for a, b in zip(off, on):
        assert np.array_equal(a.result.ids, b.result.ids)
        assert np.array_equal(a.result.dists.view(np.uint32), b.result.dists.view(np.uint32))
        assert a.result.n_expansions == b.result.n_expansions


def test_untraced_post_path_calls_the_index_plainly(system):
    """Untraced, the post path calls ``index.search(queries, k, nprobe=)``,
    so a stand-in of that signature still serves: the benchmark's fault
    checks put one in the engine's IVF index to alter its answers."""
    *_, eng, qs, preds = system
    real = eng.post_exec.index

    class Plain:
        n, n_lists = real.n, real.n_lists

        def search(self, queries, k, nprobe=8, mask=None):
            return real.search(queries, k, nprobe=nprobe, mask=mask)

    want = eng.post_exec.search_rows(qs[3:], preds[3:], K, [0.6] * 8)
    eng.post_exec.index = Plain()
    try:
        got = eng.post_exec.search_rows(qs[3:], preds[3:], K, [0.6] * 8)
    finally:
        eng.post_exec.index = real
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def test_tracing_off_opens_nothing_and_times_nothing(system):
    *_, eng, qs, preds = system
    _traced(eng, qs, preds, NULL_TRACER)
    assert list(NULL_TRACER.spans()) == []
    assert ops._EVENTS is None and ops._READERS == 0


def test_kernel_subcost_is_the_wall_on_the_cpu(system):
    *_, eng, qs, preds = system
    tr = Tracer()
    _traced(eng, qs, preds, tr)
    execute = tr.roots[1]
    assert execute.wall_detail["kernel:fused_masked_topk"] > 0.0
    assert execute.wall_detail["kernel:fused_masked_topk"] <= execute.wall_s
    # the device-time reader closed with the span, having timed nothing
    assert ops._EVENTS is None and ops._READERS == 0
    mark = ops.device_timing_begin()
    q = torch.zeros(1, 4)
    ops.fused_masked_topk(q, torch.ones(8, 4), torch.ones(8, dtype=torch.bool), 2)
    assert ops.device_timing_end(mark) == {}


def test_a_raising_execute_closes_the_reader_and_keeps_its_error(system, monkeypatch):
    *_, eng, qs, preds = system

    def boom(*args, **kwargs):
        raise MemoryError("out of device memory")

    monkeypatch.setattr(eng.pre_exec.__class__, "search_masked", boom)
    with pytest.raises(MemoryError, match="out of device memory"):
        _traced(eng, qs, preds, Tracer())
    assert ops._EVENTS is None and ops._READERS == 0


def test_the_reader_leaves_out_a_launch_that_has_not_ended():
    class Event:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

        def elapsed_time(self, end):
            if not end.done:
                raise RuntimeError("the end event has not completed")
            return 2.0

    mark = ops.device_timing_begin()
    ops._EVENTS += [("fused_masked_topk", Event(True), Event(True)),
                    ("fused_masked_topk", Event(True), Event(False))]
    assert ops.device_timing_end(mark) == {"fused_masked_topk": 2e-3}
    assert ops._EVENTS is None and ops._READERS == 0


@pytest.mark.cuda
def test_kernel_subcost_is_device_time_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA events time the launches there")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(200_000, 128, device=dev, generator=g)
    q = torch.randn(16, 128, device=dev, generator=g)
    m = torch.rand(200_000, device=dev, generator=g) < 0.5
    ops.fused_masked_topk(q, x, m, 10)                       # build and warm
    torch.cuda.synchronize(dev)
    mark = ops.device_timing_begin()
    d, i = ops.fused_masked_topk(q, x, m, 10)
    i.cpu()
    got = ops.device_timing_end(mark)
    assert set(got) == {"fused_masked_topk"} and got["fused_masked_topk"] > 0.0
    assert ops._EVENTS is None
    # the same launch timed alone with events
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    ops.fused_masked_topk(q, x, m, 10)
    b.record()
    b.synchronize()
    alone = 1e-3 * a.elapsed_time(b)
    assert 0.5 * alone < got["fused_masked_topk"] < 2.0 * alone + 1e-4
