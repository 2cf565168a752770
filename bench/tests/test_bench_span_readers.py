"""The readers of the program's spans inside a group, the IVF post path and
predicate compilation, on a hand-built span tree; and their idle time
charged by name."""
from __future__ import annotations

import numpy as np
import pytest
from repro_torch.obs.trace import Span

from bench import harness
from bench.check import Readings
from bench.devtrace import SPAN_PREFIX, WINDOW_LABEL, read_profile

from conftest import REPO
from test_bench_readers import _Ev, _Prof

NEW = ("mask_ms_per_query", "h2d_bytes_per_query", "ivf_ms_per_row", "post_check_ms_per_row",
       "ivf_passes_per_row", "bitmap_compile_ms_per_query")


def _span(name, wall, parent=-1, **attrs):
    return Span(name=name, span_id=0, parent_id=parent, attrs=attrs, wall_s=wall)


def _old_spans():
    """What a program without the new spans opens (no reader finds a thing)."""
    return [
        _span("plan", 0.010), _span("predicate_compile", 0.006, parent=0),
        _span("execute", 0.100),
        _span("group", 0.020, parent=2, decision="ipre", n_rows=4, n_candidates=200_000),
        _span("group", 0.050, parent=2, decision="post", n_rows=6),
        _span("group", 0.010, parent=2, decision="post", n_rows=4),
    ]


def _spans():
    return _old_spans() + [
        _span("bitmap_compile", 0.003, parent=1), _span("bitmap_compile", 0.001, parent=1),
        _span("mask", 0.002, parent=3), _span("h2d", 0.001, parent=3, bytes=2_001_536),
        _span("gather", 0.001, parent=3), _span("scan", 0.004, parent=3),
        # post group 1: a round over all 6 rows, a second over 2 of them
        _span("ivf.search", 0.020, parent=4, n_rows=6), _span("h2d", 0.0, parent=11, bytes=9_216),
        _span("ivf.probe", 0.005, parent=11), _span("ivf.scan", 0.012, parent=11),
        _span("h2d", 0.0, parent=14, bytes=16_000), _span("h2d", 0.001, parent=14, bytes=32_000),
        _span("post.check", 0.006, parent=4),
        _span("ivf.search", 0.010, parent=4, n_rows=2), _span("post.check", 0.002, parent=4),
        # post group 2: a routed group, no IVF search, its mask only
        _span("mask", 0.003, parent=5),
        _span("package", 0.001),
    ]


def _ctx(spans):
    return harness.Context(
        setup_s=20.0, window_s=2.0, queries=10, batch=5, latencies=np.array([0.01, 0.02]),
        strategies=["ipre"] * 5 + ["post"] * 5, launches={"masked_l2_topk": 1},
        readings=Readings(recall_sum=9.0, recall_rows=10), rows=1_000_000, dim=384, k=10,
        device_kind="NVIDIA H100 80GB HBM3", spans=spans, profile=None)


def _read(name, ctx):
    return harness.load_reader(REPO, name)(ctx)


def test_span_readers():
    ctx = _ctx(_spans())
    assert _read("mask_ms_per_query", ctx) == pytest.approx(0.5)               # 5 ms over 10
    assert _read("h2d_bytes_per_query", ctx) == pytest.approx(205_875.2)       # 2,058,752 B over 10
    # over the post groups' 10 rows
    assert _read("ivf_ms_per_row", ctx) == pytest.approx(3.0)                  # 30 ms
    assert _read("post_check_ms_per_row", ctx) == pytest.approx(0.8)           # 8 ms
    assert _read("ivf_passes_per_row", ctx) == pytest.approx(0.8)              # 8 rows searched
    assert _read("bitmap_compile_ms_per_query", ctx) == pytest.approx(0.4)     # 4 ms over 10


@pytest.mark.parametrize("spans", [[], _old_spans()], ids=["untraced", "without-new-spans"])
def test_span_readers_find_nothing(spans):
    for name in NEW:
        assert _read(name, _ctx(spans)) is None, name


def test_span_readers_need_queries_and_post_rows():
    spans = [s for s in _spans() if not (s.name == "group" and s.attrs["decision"] == "post")]
    for name in ("ivf_ms_per_row", "post_check_ms_per_row", "ivf_passes_per_row"):
        assert _read(name, _ctx(spans)) is None, name
    empty = _ctx(_spans())
    empty.queries = 0
    for name in ("mask_ms_per_query", "h2d_bytes_per_query", "bitmap_compile_ms_per_query"):
        assert _read(name, empty) is None, name


def test_idle_time_is_charged_to_the_new_spans():
    """Idle time inside a group goes to its innermost new span, and only
    what no new span covers stays with the group."""
    ms = 1_000_000
    ev = [
        _Ev(WINDOW_LABEL, 0, 100 * ms, ann=True),
        _Ev(SPAN_PREFIX + "execute", 0, 100 * ms, ann=True),
        _Ev(SPAN_PREFIX + "group.ipre", 0, 50 * ms, ann=True),
        _Ev(SPAN_PREFIX + "mask", 0, 30 * ms, ann=True),
        _Ev(SPAN_PREFIX + "h2d", 30 * ms, 35 * ms, ann=True),
        _Ev(SPAN_PREFIX + "scan", 38 * ms, 50 * ms, ann=True),
        _Ev(SPAN_PREFIX + "group.post", 50 * ms, 100 * ms, ann=True),
        _Ev(SPAN_PREFIX + "ivf.search", 50 * ms, 80 * ms, ann=True),
        _Ev(SPAN_PREFIX + "ivf.scan", 60 * ms, 80 * ms, ann=True),
        _Ev(SPAN_PREFIX + "post.check", 80 * ms, 99 * ms, ann=True),
        _Ev("Memcpy HtoD (Pageable -> Device)", 31 * ms, 35 * ms, dev=True),
        _Ev("gatherTopK", 40 * ms, 42 * ms, dev=True),
    ]
    gaps = dict(read_profile(_Prof(ev)).idle_gaps)
    assert gaps["mask"] == pytest.approx(0.030)
    assert gaps["h2d"] == pytest.approx(0.001)
    assert gaps["group.ipre"] == pytest.approx(0.003)        # 35-38: between h2d and scan
    assert gaps["scan"] == pytest.approx(0.010)
    assert gaps["ivf.search"] == pytest.approx(0.010)        # 50-60: before ivf.scan opens
    assert gaps["ivf.scan"] == pytest.approx(0.020)
    assert gaps["post.check"] == pytest.approx(0.019)
    assert gaps["group.post"] == pytest.approx(0.001)
