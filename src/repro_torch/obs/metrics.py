"""One metrics registry for every serving layer.

Port of ``repro/obs/metrics.py``; the registry, ``publish_stats`` and
``publish_kernel_dispatch`` are copies.  ``publish_kernel_budget`` reports
the Hopper kernel's own budget, per-block dynamic shared memory, in place
of the reference's TPU VMEM working set.

Counters, gauges, and histograms with label sets; iteration order is
deterministic everywhere (metric names sorted, label sets sorted within a
metric), so two replays of the same trace produce byte-identical
snapshots and Prometheus expositions.  ``runtime.Telemetry`` and
``fleet.FleetTelemetry`` store their deterministic ledgers here (the
fleet shares ONE registry across tenants via a ``tenant`` label), and the
``publish_*`` helpers fold process-level sources — engine ``stats()``
dicts, kernel dispatch counters, the masked top-k kernel's shared-memory
budget — into the same namespace.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry",
    "publish_stats",
    "publish_kernel_dispatch",
    "publish_kernel_budget",
]

# seconds-scale latency buckets (virtual or wall)
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats print as ints, the rest as
    repr (shortest round-trip — deterministic for identical doubles)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class MetricsRegistry:
    """Label-set metric store with deterministic iteration.

    Series are keyed by their sorted ``(label, value)`` tuple, so the same
    logical labels always address the same series regardless of call-site
    keyword order.
    """

    def __init__(self):
        # name -> {"kind", "help", "buckets"?, "series": {label_key: value}}
        self._metrics: Dict[str, Dict[str, Any]] = {}

    # -- recording ------------------------------------------------------
    @staticmethod
    def _key(labels: Dict[str, Any]) -> LabelKey:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def _metric(self, name: str, kind: str, help: str = "") -> Dict[str, Any]:
        m = self._metrics.get(name)
        if m is None:
            m = {"kind": kind, "help": help, "series": {}}
            self._metrics[name] = m
        elif m["kind"] != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m['kind']}, not {kind}")
        if help and not m["help"]:
            m["help"] = help
        return m

    def inc(self, name: str, value: float = 1, help: str = "", **labels) -> None:
        """Add to a counter (``value=0`` pre-creates the series at zero, so
        fixed enumerations — plan names, SLO tiers — appear in snapshots
        before their first event)."""
        if value < 0:
            raise ValueError(f"counter {name!r} cannot decrease (got {value})")
        s = self._metric(name, "counter", help)["series"]
        key = self._key(labels)
        s[key] = s.get(key, 0) + value

    def set_gauge(self, name: str, value: float, help: str = "", **labels) -> None:
        s = self._metric(name, "gauge", help)["series"]
        s[self._key(labels)] = value

    def observe(self, name: str, value: float, help: str = "",
                buckets: Sequence[float] = DEFAULT_BUCKETS, **labels) -> None:
        m = self._metric(name, "histogram", help)
        m.setdefault("buckets", tuple(buckets))
        s = m["series"]
        key = self._key(labels)
        h = s.get(key)
        if h is None:
            h = {"count": 0, "sum": 0.0,
                 "bucket_counts": [0] * len(m["buckets"])}
            s[key] = h
        h["count"] += 1
        h["sum"] += float(value)
        for i, le in enumerate(m["buckets"]):
            if value <= le:
                h["bucket_counts"][i] += 1

    # -- reading --------------------------------------------------------
    def value(self, name: str, default: float = 0, **labels) -> float:
        m = self._metrics.get(name)
        if m is None:
            return default
        return m["series"].get(self._key(labels), default)

    def series(self, name: str, match: Optional[Dict[str, Any]] = None,
               ) -> List[Tuple[Dict[str, str], Any]]:
        """All (labels, value) pairs of a metric, sorted by label key;
        ``match`` filters to series whose labels contain every given pair."""
        m = self._metrics.get(name)
        if m is None:
            return []
        need = tuple(sorted((str(k), str(v)) for k, v in (match or {}).items()))
        out = []
        for key in sorted(m["series"]):
            if all(pair in key for pair in need):
                out.append((dict(key), m["series"][key]))
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Deterministic JSON-able dump of every metric and series."""
        out: Dict[str, Any] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = []
            for key in sorted(m["series"]):
                v = m["series"][key]
                if m["kind"] == "histogram":
                    v = {"count": v["count"], "sum": v["sum"],
                         "buckets": {_fmt(le): c for le, c in
                                     zip(m["buckets"], v["bucket_counts"])}}
                series.append({"labels": dict(key), "value": v})
            out[name] = {"kind": m["kind"], "series": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, deterministically ordered."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m["help"]:
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {m['kind']}")
            for key in sorted(m["series"]):
                v = m["series"][key]
                if m["kind"] == "histogram":
                    cum = 0
                    for le, c in zip(m["buckets"], v["bucket_counts"]):
                        cum += c
                        lines.append(
                            f"{name}_bucket{self._labels(key, le=_fmt(le))} {cum}")
                    lines.append(
                        f"{name}_bucket{self._labels(key, le='+Inf')} {v['count']}")
                    lines.append(f"{name}_sum{self._labels(key)} {_fmt(v['sum'])}")
                    lines.append(f"{name}_count{self._labels(key)} {v['count']}")
                else:
                    lines.append(f"{name}{self._labels(key)} {_fmt(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def _labels(key: LabelKey, **extra: str) -> str:
        pairs = list(key) + sorted(extra.items())
        if not pairs:
            return ""
        inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
        return "{" + inner + "}"

    def clear(self) -> None:
        self._metrics.clear()


# ----------------------------------------------------------------------
# publishers: fold non-registry sources into the shared namespace
# ----------------------------------------------------------------------
def publish_stats(registry: MetricsRegistry, stats: Dict[str, Any],
                  prefix: str = "repro_engine", **labels) -> None:
    """Flatten a nested ``stats()`` dict into gauges: numeric leaves become
    ``<prefix>_<path.joined.by.underscores>``; non-numeric leaves skip."""
    def walk(path: str, node: Any) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{path}_{k}" if path else str(k), node[k])
        elif isinstance(node, bool):
            registry.set_gauge(f"{prefix}_{path}", int(node), **labels)
        elif isinstance(node, (int, float)):
            registry.set_gauge(f"{prefix}_{path}", node, **labels)

    walk("", stats)


def publish_kernel_dispatch(registry: MetricsRegistry) -> None:
    """Mirror the process-global kernel dispatch counters/wall accumulated
    in ``repro_torch.kernels.ops`` into gauges (gauges, not counters: the
    source is cumulative already).  The wall is enqueue time: device work
    is asynchronous and reaches the host at the caller."""
    from ..kernels import ops

    for name, n in ops.dispatch_counts().items():
        registry.set_gauge("repro_kernel_dispatch_total", n, kernel=name)
    for name, s in ops.dispatch_wall().items():
        registry.set_gauge("repro_kernel_wall_seconds", s, kernel=name)


def publish_kernel_budget(registry: MetricsRegistry,
                          dims: Sequence[int] = (128, 256, 512)) -> None:
    """Register the masked top-k kernel's per-block dynamic shared memory
    (``kernels.masked_l2.smem_bytes`` at k = ``KPAD``) for every query tile
    it launches with, streaming (1, 8) and tiled (64, 32), at each width in
    ``dims``, against the sm_90 block limit ``SMEM_MAX``: gauges
    ``repro_kernel_smem_bytes`` and ``repro_kernel_smem_fits_sm90``
    labelled ``kernel=masked_l2_d<d>`` and ``qt``.  A tile that does not fit
    is one ``masked_l2.plan`` never picks at that width."""
    from ..kernels.masked_l2 import KPAD, SMEM_MAX, TILED_QT, smem_bytes

    for d in dims:
        k = f"masked_l2_d{d}"
        for qt in (1, 8, *TILED_QT):
            smem = smem_bytes(qt, d, KPAD)
            registry.set_gauge("repro_kernel_smem_bytes", smem, kernel=k, qt=qt)
            registry.set_gauge("repro_kernel_smem_fits_sm90", int(smem <= SMEM_MAX),
                               kernel=k, qt=qt)
