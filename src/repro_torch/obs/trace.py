"""Hierarchical query tracing under the two-ledger discipline.

Port of ``repro/obs/trace.py`` (plain Python, copied).

A :class:`Tracer` records a tree of :class:`Span` objects per serving
request/batch.  Every span carries TWO strictly separated ledgers:

* **deterministic** — the span's name, position in the tree, sequential
  ``span_id``, and ``attrs`` (cache hit/miss deltas, decision groups,
  candidate counts, kernel dispatch counts...).  All of these derive from
  the trace + engine state only, so the same trace + seed reproduces the
  span tree bit-for-bit (:meth:`Tracer.deterministic_tree` is what replay
  tests compare).
* **wall** — measured seconds (``wall_s`` for the span body,
  ``wall_detail`` for named sub-costs such as per-kernel time).  Real
  clocks never leak into attrs.

``NULL_TRACER`` is the default no-op wired into the engines: the serving
path pays one context-manager enter/exit per instrumented stage and
nothing else when tracing is off.  :func:`span_summary` aggregates a
recorded tracer into a per-stage wall ranking.

On a CUDA device a span's ``wall_s`` ends after its device work: the
executors hand back host arrays, which waits for the device.  The
``kernel:<name>`` sub-costs of an ``execute`` span are, for
``repro_torch.kernels.ops.fused_masked_topk`` on a CUDA device, its
launches' device time from CUDA events, recorded only while a tracer is
enabled and read at the span's close, after the results' host copy;
elsewhere (the CPU, the IVF search, the routed backends) they are the
dispatch call's wall.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Span", "Tracer", "NULL_TRACER", "span_summary"]


def _clean(v: Any) -> Any:
    """Coerce attr values to plain JSON-stable Python scalars (numpy ints/
    floats carried into attrs would still be deterministic, but their repr
    is not portable across dtypes)."""
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        try:
            return v.item()
        except (TypeError, ValueError):
            return str(v)
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _clean(x) for k, x in v.items()}
    return v


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: int                                    # -1 for roots
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    children: List["Span"] = dataclasses.field(default_factory=list)
    # real ledger — excluded from deterministic comparisons
    wall_s: float = 0.0
    wall_detail: Dict[str, float] = dataclasses.field(default_factory=dict)

    def deterministic(self) -> Dict[str, Any]:
        """The replay-comparable projection: structure + attrs, no wall."""
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "attrs": {k: self.attrs[k] for k in sorted(self.attrs)},
            "children": [c.deterministic() for c in self.children],
        }

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()


class Tracer:
    """Collects a forest of spans; one instance per traced run."""

    enabled = True

    def __init__(self):
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        self._next_id = 0

    # -- recording ------------------------------------------------------
    def span(self, name: str, **attrs) -> "_SpanContext":
        """Open a child span of the current one (a root when none is open);
        use as a context manager.  ``attrs`` must be deterministic values."""
        return _SpanContext(self, name, attrs)

    def annotate(self, **attrs) -> None:
        """Attach deterministic attributes to the innermost open span."""
        if self._stack:
            self._stack[-1].attrs.update({k: _clean(v) for k, v in attrs.items()})

    def add_wall(self, key: str, seconds: float) -> None:
        """Accumulate a named wall-clock sub-cost (real ledger only)."""
        if self._stack:
            d = self._stack[-1].wall_detail
            d[key] = d.get(key, 0.0) + float(seconds)

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def reset(self) -> None:
        self.roots, self._stack, self._next_id = [], [], 0

    # -- reading --------------------------------------------------------
    def spans(self) -> Iterator[Span]:
        for r in self.roots:
            yield from r.walk()

    def deterministic_tree(self) -> List[Dict[str, Any]]:
        """The full forest on the deterministic ledger only — bit-identical
        across replays of the same trace + seed + engine state."""
        return [r.deterministic() for r in self.roots]

    def write_jsonl(self, path) -> None:
        """One JSON object per span, depth-first; deterministic fields
        first, wall clock under a separate ``wall`` key."""
        with open(path, "w") as f:
            for sp in self.spans():
                f.write(json.dumps({
                    "span_id": sp.span_id,
                    "parent_id": sp.parent_id,
                    "name": sp.name,
                    "attrs": {k: sp.attrs[k] for k in sorted(sp.attrs)},
                    "wall": {
                        "s": round(sp.wall_s, 9),
                        "detail": {k: round(v, 9)
                                   for k, v in sorted(sp.wall_detail.items())},
                    },
                }) + "\n")

    def span_summary(self) -> List[Dict[str, Any]]:
        return span_summary(self)


class _SpanContext:
    __slots__ = ("_tracer", "_name", "_attrs", "_span", "_t0")

    def __init__(self, tracer: Tracer, name: str, attrs: Dict[str, Any]):
        self._tracer, self._name, self._attrs = tracer, name, attrs

    def __enter__(self) -> Span:
        tr = self._tracer
        parent = tr._stack[-1] if tr._stack else None
        sp = Span(
            name=self._name,
            span_id=tr._next_id,
            parent_id=parent.span_id if parent is not None else -1,
            attrs={k: _clean(v) for k, v in self._attrs.items()},
        )
        tr._next_id += 1
        (parent.children if parent is not None else tr.roots).append(sp)
        tr._stack.append(sp)
        self._span = sp
        self._t0 = time.perf_counter()
        return sp

    def __exit__(self, *exc) -> bool:
        self._span.wall_s += time.perf_counter() - self._t0
        self._tracer._stack.pop()
        return False


class _NullSpanContext:
    """Shared no-op context: tracing off costs one enter/exit, no allocs."""

    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = Span(name="", span_id=-1, parent_id=-1)
_NULL_CTX = _NullSpanContext()


class NullTracer(Tracer):
    """Do-nothing tracer — the engines' default, so instrumented code never
    branches on "is tracing on"."""

    enabled = False

    def span(self, name: str, **attrs):
        return _NULL_CTX

    def annotate(self, **attrs) -> None:
        pass

    def add_wall(self, key: str, seconds: float) -> None:
        pass


NULL_TRACER = NullTracer()


def span_summary(tracer: Tracer) -> List[Dict[str, Any]]:
    """Rank stages by wall time across a recorded tracer.

    One row per span name with ``count``, inclusive ``wall_s``, and
    exclusive ``self_s`` (inclusive minus children — the stage's own
    cost); per-kernel sub-costs recorded via ``add_wall`` surface as
    ``kernel:<name>`` pseudo-stages (``fused_masked_topk``'s device time
    on a CUDA device, else the call's wall; the reference ranks them
    against its ``launch/roofline.py``, which the port does not have
    yet).  Sorted by
    ``self_s`` descending (ties broken by name for determinism of the
    row ORDER — the wall values themselves are the real ledger).
    """
    rows: Dict[str, Dict[str, Any]] = {}

    def bump(name: str, wall: float, self_s: float, count: int = 1) -> None:
        r = rows.setdefault(name, {"stage": name, "count": 0,
                                   "wall_s": 0.0, "self_s": 0.0})
        r["count"] += count
        r["wall_s"] += wall
        r["self_s"] += self_s

    for sp in tracer.spans():
        child_s = sum(c.wall_s for c in sp.children)
        bump(sp.name, sp.wall_s, max(sp.wall_s - child_s, 0.0))
        for key, s in sp.wall_detail.items():
            bump(key, s, s, count=0)
    out = sorted(rows.values(), key=lambda r: (-r["self_s"], r["stage"]))
    for r in out:
        r["wall_s"] = round(r["wall_s"], 6)
        r["self_s"] = round(r["self_s"], 6)
    return out
