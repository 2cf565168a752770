"""Reading the traced window: the program's spans on the profiler's clock,
device activity, idle gaps and per-kernel device time.

With ``--trace 1`` the harness installs :class:`ProfiledTracer`, the
program's own ``obs.trace.Tracer`` whose every span also opens a
``torch.profiler.record_function`` range named ``SPAN_PREFIX + label``
(``group`` spans are labelled by their decision: ``group.post``), and runs
the window under ``torch.profiler`` with CPU and CUDA activity.  From the
profiler's raw events (no key averages):

* device activity: every CUDA event that is not a user annotation;
  ``busy_s`` is the union of their intervals inside the window;
* idle gaps: the window less that union, each piece charged to the
  innermost program span open on the host at the time (``harness`` when
  none is: the harness between calls);
* per-name device seconds, summed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["ProfiledTracer", "DeviceProfile", "read_profile", "SPAN_PREFIX", "WINDOW_LABEL"]

SPAN_PREFIX = "bench.span:"
WINDOW_LABEL = "bench.window"


def ProfiledTracer():
    """A program ``Tracer`` whose spans are also profiler ranges."""
    import torch
    from repro_torch.obs.trace import Tracer

    class _Ctx:
        __slots__ = ("inner", "label", "rf")

        def __init__(self, inner, label):
            self.inner, self.label = inner, label

        def __enter__(self):
            self.rf = torch.profiler.record_function(SPAN_PREFIX + self.label)
            self.rf.__enter__()
            return self.inner.__enter__()

        def __exit__(self, *exc):
            out = self.inner.__exit__(*exc)
            self.rf.__exit__(*exc)
            return out

    class _Tracer(Tracer):
        def span(self, name: str, **attrs):
            label = name
            if name == "group" and "decision" in attrs:
                label = f"group.{attrs['decision']}"
            return _Ctx(super().span(name, **attrs), label)

    return _Tracer()


@dataclasses.dataclass
class DeviceProfile:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]           # (name, summed device s), largest first
    idle_gaps: List[Tuple[str, float]]            # (innermost span, idle s), largest first

    def device_seconds(self, names) -> float:
        """Summed device seconds of the ops whose name contains one of ``names``."""
        return sum(s for op, s in self.device_ops if any(n in op for n in names))


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _labelled_segments(spans: List[Tuple[int, int, str]], w0: int, w1: int):
    """Disjoint (start, end, innermost label) pieces of [w0, w1]."""
    marks = []
    for i, (a, b, _) in enumerate(spans):
        marks.append((a, 1, -b, i))
        marks.append((b, 0, 0, i))
    marks.sort()
    out, stack, t = [], [], w0
    for tm, kind, _, i in marks:
        tm = min(max(tm, w0), w1)
        if tm > t:
            out.append((t, tm, spans[stack[-1]][2] if stack else "harness"))
            t = tm
        if kind == 1:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if w1 > t:
        out.append((t, w1, spans[stack[-1]][2] if stack else "harness"))
    return out


def read_profile(prof, top: int = 10) -> Optional[DeviceProfile]:
    """The window's device profile, or None when the trace holds no window."""
    from torch.autograd import DeviceType

    window: Optional[Tuple[int, int]] = None
    dev: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith(("bench.", SPAN_PREFIX)):
                dev.append((a, b, name))
        elif name == WINDOW_LABEL:
            window = (a, b)
        elif name.startswith(SPAN_PREFIX):
            spans.append((a, b, name[len(SPAN_PREFIX):]))
    if window is None:
        return None
    w0, w1 = window
    busy_iv = _union([(max(a, w0), min(b, w1)) for a, b, _ in dev if b > w0 and a < w1])
    busy = sum(b - a for a, b in busy_iv)
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        if b > w0 and a < w1:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    # idle pieces of the window, charged to the innermost span open then
    idle, t = [], w0
    for a, b in busy_iv:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if w1 > t:
        idle.append((t, w1))
    gaps: Dict[str, float] = {}
    segs = _labelled_segments([s for s in spans if s[1] > w0 and s[0] < w1], w0, w1)
    i = j = 0
    while i < len(idle) and j < len(segs):
        a = max(idle[i][0], segs[j][0])
        b = min(idle[i][1], segs[j][1])
        if b > a:
            gaps[segs[j][2]] = gaps.get(segs[j][2], 0.0) + (b - a) * 1e-9
        if idle[i][1] <= segs[j][1]:
            i += 1
        else:
            j += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return DeviceProfile(
        window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, device_ops=ops,
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top])
