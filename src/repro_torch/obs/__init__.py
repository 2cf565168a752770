"""repro_torch.obs — observability for the serving path.

Port of ``repro/obs``, with the same public names.

Three pieces, one discipline:

* :mod:`repro_torch.obs.trace`   — hierarchical two-ledger spans: deterministic
  structure/attributes (replay-comparable) strictly separated from
  measured wall time.
* :mod:`repro_torch.obs.metrics` — one :class:`MetricsRegistry` (counters /
  gauges / histograms with label sets, deterministic iteration) behind
  ``runtime.Telemetry``, ``fleet.FleetTelemetry``, and the engine's
  ``stats()`` publishers; Prometheus text exposition + JSON snapshot.
* :mod:`repro_torch.obs.probe`   — a live recall probe racing a seeded sample
  of served queries against the exact masked top-k oracle, per
  (plan, backend, knob) class.
"""
from .metrics import (
    MetricsRegistry,
    publish_kernel_budget,
    publish_kernel_dispatch,
    publish_stats,
)
from .probe import RecallProbe
from .trace import NULL_TRACER, Span, Tracer, span_summary

__all__ = [
    "MetricsRegistry",
    "NULL_TRACER",
    "RecallProbe",
    "Span",
    "Tracer",
    "publish_kernel_budget",
    "publish_kernel_dispatch",
    "publish_stats",
    "span_summary",
]
