"""Each metric reader, and the trace reading, on a recorded span tree and profile."""
from __future__ import annotations

import numpy as np
import pytest
from repro_torch.obs.trace import Span
from torch.autograd import DeviceType

from bench import harness
from bench.check import Readings
from bench.devtrace import SPAN_PREFIX, WINDOW_LABEL, DeviceProfile, read_profile
from bench.work import masked_l2_topk_work, peaks

from conftest import REPO

H100 = "NVIDIA H100 80GB HBM3"
STREAM = "void (anonymous namespace)::l2_topk_stream<8>(float const*, float const*)"
MERGE = "(anonymous namespace)::l2_topk_merge(float const*, int const*)"


def _span(name, wall, parent=-1, **attrs):
    return Span(name=name, span_id=0, parent_id=parent, attrs=attrs, wall_s=wall)


def _ctx(**kw):
    spans = [
        _span("plan", 0.010), _span("plan", 0.030),
        _span("predicate_compile", 0.004, parent=0),
        _span("execute", 0.100), _span("execute", 0.060),
        _span("group", 0.020, parent=3, decision="ipre", n_rows=4, n_candidates=200_000),
        _span("group", 0.010, parent=3, decision="pre", n_rows=1, n_candidates=900_000),
        _span("group", 0.050, parent=4, decision="post", n_rows=5),
        _span("group", 0.030, parent=4, decision="post", n_rows=5),
    ]
    profile = DeviceProfile(window_s=2.0, busy_s=0.5,
                            device_ops=[(STREAM, 0.004), ("Memcpy HtoD (Pageable -> Device)", 0.3),
                                        (MERGE, 0.001)],
                            idle_gaps=[("group.post", 1.0)])
    base = dict(setup_s=31.5, window_s=2.0, queries=10, batch=5,
                latencies=np.array([0.01, 0.02]), strategies=["ipre"] * 5 + ["post"] * 5,
                launches={"masked_l2_topk": 2, "decode_attention": 0},
                readings=Readings(recall_sum=7.5, recall_rows=10), rows=1_000_000, dim=384,
                k=10, device_kind=H100, spans=spans, profile=profile)
    base.update(kw)
    return harness.Context(**base)


def _read(name, ctx):
    return harness.load_reader(REPO, name)(ctx)


def test_end_to_end_readers():
    ctx = _ctx()
    assert _read("qps", ctx) == pytest.approx(5.0)
    assert _read("setup_s", ctx) == 31.5
    assert _read("recall_at_10", ctx) == pytest.approx(0.75)
    # ten queries, five at 10 ms and five at 20 ms
    assert _read("p95_ms.host", ctx) == pytest.approx(np.percentile([10] * 5 + [20] * 5, 95))


def test_span_and_counter_readers():
    ctx = _ctx()
    assert _read("plan_ms_per_query", ctx) == pytest.approx(4.0)       # 40 ms over 10
    assert _read("execute_ms_per_query", ctx) == pytest.approx(16.0)   # 160 ms over 10
    assert _read("post_ms_per_row", ctx) == pytest.approx(8.0)         # 80 ms over 10 rows
    assert _read("post_row_share", ctx) == pytest.approx(0.5)
    assert _read("l2topk_launches_per_query", ctx) == pytest.approx(0.2)
    assert _read("device_idle_share", ctx) == pytest.approx(0.75)
    none = _ctx(spans=[], profile=None, strategies=["ipre"] * 10)
    assert _read("post_ms_per_row", none) is None
    assert _read("masked_l2_topk_roofline", none) is None
    assert _read("device_idle_share", none) is None
    assert _read("post_row_share", none) == 0.0


def test_roofline_reader():
    ctx = _ctx()
    peak = peaks(H100)
    least = 0.0
    for b, n_pass in ((4, 200_000), (1, 900_000)):
        nbytes, ops = masked_l2_topk_work(b, ctx.rows, n_pass, ctx.dim, ctx.k)
        least += max(nbytes / peak["bytes_per_s"], ops / peak["flops"])
    assert _read("masked_l2_topk_roofline", ctx) == pytest.approx(100 * least / 0.005)
    # the gathered branch reads no mask beyond its passing rows; the full one all N
    assert masked_l2_topk_work(1, 1000, 100, 8, 10) == (4 * 8 + 100 + 4 * 100 * 8 + 80,
                                                        2 * 100 * 8 + 2 * 100 * 8)
    assert masked_l2_topk_work(1, 1000, 900, 8, 10)[0] == 4 * 8 + 1000 + 4 * 900 * 8 + 80
    assert _read("masked_l2_topk_roofline", _ctx(device_kind="another card")) is None


class _Ev:
    def __init__(self, name, a, b, dev=False, ann=False):
        self._n, self._a, self._b, self._d, self._u = name, a, b, dev, ann

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def is_user_annotation(self):
        return self._u


class _Prof:
    def __init__(self, events):
        class R:
            def events(_):
                return events

        class P:
            kineto_results = R()
        self.profiler = P()


def test_read_profile_busy_gaps_and_ops():
    ms = 1_000_000
    ev = [
        _Ev(WINDOW_LABEL, 0, 100 * ms, ann=True),
        _Ev(SPAN_PREFIX + "plan", 0, 20 * ms, ann=True),
        _Ev(SPAN_PREFIX + "execute", 20 * ms, 90 * ms, ann=True),
        _Ev(SPAN_PREFIX + "group.ipre", 30 * ms, 60 * ms, ann=True),
        _Ev(SPAN_PREFIX + "group.ipre", 30 * ms, 60 * ms, dev=True, ann=True),  # gpu annotation
        _Ev(STREAM, 40 * ms, 50 * ms, dev=True),
        _Ev("Memcpy HtoD (Pageable -> Device)", 45 * ms, 55 * ms, dev=True),
        _Ev(STREAM, 95 * ms, 120 * ms, dev=True),            # runs past the window
        _Ev("aten::copy_", 40 * ms, 41 * ms),
    ]
    p = read_profile(_Prof(ev))
    assert p.window_s == pytest.approx(0.1)
    assert p.busy_s == pytest.approx(0.015 + 0.005)          # 40-55 and 95-100
    gaps = dict(p.idle_gaps)
    assert gaps["plan"] == pytest.approx(0.020)
    assert gaps["execute"] == pytest.approx(0.010 + 0.030)    # 20-30 and 60-90
    assert gaps["group.ipre"] == pytest.approx(0.010 + 0.005)  # 30-40 and 55-60
    assert gaps["harness"] == pytest.approx(0.005)            # 90-95
    assert sum(gaps.values()) + p.busy_s == pytest.approx(p.window_s)
    assert p.device_seconds(("l2_topk_stream",)) == pytest.approx(0.010 + 0.025)
    assert read_profile(_Prof(ev[1:])) is None
