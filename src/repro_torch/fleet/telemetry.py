"""Fleet telemetry: one deterministic ledger across all tenants.

Port of ``repro/fleet/telemetry.py`` (copied).

Wraps one per-tenant :class:`repro_torch.runtime.Telemetry` (plan mix, backend
mix, deadline accounting, latency quantiles — everything the
single-tenant runtime already measures) and adds the fleet-level
signals: admission rejects per tenant, autoscale events
(virtual-clock-stamped), and the per-tenant SLO hit-rate the
noisy-neighbor benchmark gates on.  ``counters()`` is the deterministic
ledger replay tests compare; ``snapshot()`` adds quantiles, wall-clock
throughput, and each tenant engine's partitioned cache counters.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..obs.metrics import MetricsRegistry
from ..runtime.telemetry import Telemetry

__all__ = ["FleetTelemetry"]


class FleetTelemetry:
    """All tenants publish into ONE shared :class:`MetricsRegistry`: each
    per-tenant :class:`Telemetry` carries a ``tenant`` label, so one
    ``registry.prometheus_text()`` / ``registry.snapshot()`` call exports
    the whole fleet with tenant isolation intact."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tenants: Dict[str, Telemetry] = {}
        self.scale_events: List[dict] = []

    def tenant(self, name: str) -> Telemetry:
        if name not in self.tenants:
            self.tenants[name] = Telemetry(
                registry=self.registry, labels={"tenant": name})
        return self.tenants[name]

    # ------------------------------------------------------------------
    def record_reject(self, tenant: str) -> None:
        self.registry.inc("repro_admission_rejected_total", tenant=tenant)

    @property
    def rejects(self) -> Dict[str, int]:
        return {
            lbl["tenant"]: int(v)
            for lbl, v in self.registry.series("repro_admission_rejected_total")
        }

    def record_scale(self, event) -> None:
        """``event`` is an ``autoscale.ScaleEvent`` (or any dataclass with
        an ``as_dict()``) — stored as a plain dict so the ledger stays
        JSON-serialisable and comparable across replays."""
        self.scale_events.append(
            event.as_dict() if hasattr(event, "as_dict") else dict(event))

    # ------------------------------------------------------------------
    def slo_hit_rate(self, tenant: str) -> float:
        """met / (met + missed) across that tenant's completed queries;
        1.0 when nothing completed (vacuously on-SLO)."""
        tel = self.tenants.get(tenant)
        if tel is None:
            return 1.0
        met = sum(tel.deadline_met.values())
        missed = sum(tel.deadline_missed.values())
        return met / (met + missed) if met + missed else 1.0

    def counters(self) -> Dict:
        """The deterministic ledger only (what replay tests compare)."""
        return {
            "tenants": {n: t.counters() for n, t in sorted(self.tenants.items())},
            "rejects": dict(sorted(self.rejects.items())),
            "scale_events": list(self.scale_events),
            "slo_hit_rate": {n: round(self.slo_hit_rate(n), 6)
                             for n in sorted(self.tenants)},
        }

    def snapshot(self, fleet=None) -> Dict:
        """Counters + per-tenant quantiles/wall stats; when ``fleet`` is
        given, each tenant's engine counters ride along (the partitioned
        predicate/plan caches, live-corpus stats, shard count)."""
        out = dict(self.counters())
        out["tenant_detail"] = {}
        for n, tel in sorted(self.tenants.items()):
            backend = fleet[n].backend if fleet is not None and n in fleet else None
            out["tenant_detail"][n] = tel.snapshot(backend)
        return out

    def merged(self) -> Optional[Telemetry]:
        """Convenience: the busiest tenant's Telemetry (or None) — for
        call sites that want a representative single-tenant view."""
        if not self.tenants:
            return None
        return max(self.tenants.values(), key=lambda t: t.n_completed)
