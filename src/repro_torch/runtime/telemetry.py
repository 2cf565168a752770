"""Serving-runtime telemetry: per-request, per-batch, and cache counters.

Port of ``repro/runtime/telemetry.py`` (copied).

Two strictly separated ledgers:

* **deterministic** — everything derived from virtual time and executed
  results: completion counts, plan-choice mix, batch-size histogram,
  deadline hits/misses per SLO tier, virtual latency quantiles, the
  fill-rate recall proxy, and the engine's predicate/plan cache counters
  (surfaced through ``backend.stats()``).  Same trace + seed reproduces
  these bit-for-bit.  Latencies here are VIRTUAL seconds of the cost
  model, never device times.
* **wall** — measured execution wall time (throughput accounting).  On a
  CUDA device it includes the device work: the executors hand back host
  arrays.  Real clocks are never folded into the deterministic ledger.

The counter ledger itself lives in a :class:`repro_torch.obs.MetricsRegistry`
(``self.registry``) under stable metric names (``repro_requests_total``,
``repro_plan_total{plan=}``, ``repro_deadline_total{tier=,outcome=}``,
...), so the same numbers export as a Prometheus text page or JSON
snapshot with zero double-counting; a fleet shares ONE registry across
tenants via a ``tenant`` label.  The legacy field/``counters()`` shapes
are preserved exactly on top — replay tests compare them bit-for-bit.

``snapshot()`` returns both ledgers; ``counters()`` returns only the
deterministic part, which is what the replay tests compare.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.engine import PlannedResult, STRATEGY_NAMES
from ..obs.metrics import MetricsRegistry
from .queue import RuntimeRequest

__all__ = ["Telemetry"]


def _quantiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    a = np.asarray(xs, np.float64)
    return {
        "p50": float(np.quantile(a, 0.50)),
        "p99": float(np.quantile(a, 0.99)),
        "mean": float(a.mean()),
        "max": float(a.max()),
    }


class Telemetry:
    """Accumulates runtime observations; ``snapshot()`` is the public API.

    ``registry`` lets several telemetries share one
    :class:`MetricsRegistry` (the fleet does, distinguishing tenants by
    ``labels={"tenant": name}``); by default each instance owns a fresh
    one.  Every legacy counter field (``plan_counts``, ``deadline_met``,
    ...) is a property reading back the registry, so the two views can
    never disagree.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.labels = dict(labels or {})
        # pre-create the fixed enumerations at zero so snapshots show the
        # full plan space before the first request lands
        self._inc("repro_requests_total", 0)
        self._inc("repro_batches_total", 0)
        self._inc("repro_deadline_flush_total", 0)
        self._inc("repro_compactions_total", 0)
        for n in (*STRATEGY_NAMES.values(), "dnf"):
            self._inc("repro_plan_total", 0, plan=n)
        for op in ("upsert", "delete"):
            self._inc("repro_writes_total", 0, op=op)
        # raw per-request VIRTUAL samples stay local: quantiles need the
        # actual values, not histogram buckets (still deterministic)
        self._lat: Dict[str, List[float]] = {}   # virtual latency per tier
        self._queue_wait: List[float] = []       # virtual arrival -> flush
        self._fill: List[float] = []             # recall proxy: k-slots filled
        self._expansions: List[int] = []         # post-filter effort
        self.wall_exec_s = 0.0                   # measured (NOT deterministic)

    # -- registry plumbing ---------------------------------------------
    def _inc(self, name: str, value: float = 1, **labels) -> None:
        self.registry.inc(name, value, **{**self.labels, **labels})

    def _value(self, name: str, **labels) -> float:
        return self.registry.value(name, 0, **{**self.labels, **labels})

    def _label_map(self, name: str, key: str, **match) -> Dict[str, int]:
        """``{series[key]: value}`` over this telemetry's series of a
        metric (scoped to ``self.labels`` — tenant isolation on a shared
        fleet registry)."""
        out: Dict[str, int] = {}
        for lbl, v in self.registry.series(name, match={**self.labels, **match}):
            out[lbl[key]] = int(v)
        return out

    # -- recording ------------------------------------------------------
    def record_batch(self, reqs: List[RuntimeRequest], results: List[PlannedResult],
                     t_flush: float, t_complete: float,
                     deadline_flush: bool = False) -> None:
        """One executed micro-batch: per-request latency/deadline/plan
        accounting in VIRTUAL time plus batch-level counters."""
        self._inc("repro_batches_total")
        self._inc("repro_batch_size_total", size=len(reqs))
        if deadline_flush:
            self._inc("repro_deadline_flush_total")
        for req, res in zip(reqs, results):
            self._inc("repro_requests_total")
            # plan-mix: per-disjunct DNF plans count under their own "dnf"
            # dimension, not the dominant clause's strategy
            plan = getattr(res, "plan", None)
            plan_name = (plan.strategy if plan is not None
                         else STRATEGY_NAMES[res.decision])
            self._inc("repro_plan_total", plan=plan_name)
            # backend-mix: routed (backend:knob) execution counts — strategy
            # name stands in for rows executed before routing existed
            bk = getattr(res.result, "backend", "") or plan_name
            knob = getattr(res.result, "knob", "")
            self._inc("repro_route_total",
                      route=f"{bk}:{knob}" if knob else bk)
            lat = t_complete - req.t_arrival
            self._lat.setdefault(req.tier, []).append(lat)
            self.registry.observe("repro_latency_virtual_seconds", lat,
                                  tier=req.tier, **self.labels)
            self._queue_wait.append(t_flush - req.t_arrival)
            outcome = "met" if t_complete <= req.deadline else "missed"
            self._inc("repro_deadline_total", tier=req.tier, outcome=outcome)
            ids = res.result.ids
            self._fill.append(float((ids >= 0).sum()) / max(ids.size, 1))
            self._expansions.append(res.result.n_expansions)

    def record_wall(self, seconds: float) -> None:
        self.wall_exec_s += seconds

    def record_writes(self, n_upsert_rows: int, n_delete_rows: int,
                      n_compactions: int = 0) -> None:
        """Row counts from one batch's applied writes (virtual ledger)."""
        self._inc("repro_writes_total", n_upsert_rows, op="upsert")
        self._inc("repro_writes_total", n_delete_rows, op="delete")
        self._inc("repro_compactions_total", n_compactions)

    # -- legacy field compat (read back from the registry) --------------
    @property
    def n_completed(self) -> int:
        return int(self._value("repro_requests_total"))

    @property
    def n_batches(self) -> int:
        return int(self._value("repro_batches_total"))

    @property
    def plan_counts(self) -> Dict[str, int]:
        m = self._label_map("repro_plan_total", "plan")
        return {n: m.get(n, 0) for n in (*STRATEGY_NAMES.values(), "dnf")}

    @property
    def backend_counts(self) -> Dict[str, int]:
        return self._label_map("repro_route_total", "route")

    @property
    def batch_sizes(self) -> Dict[int, int]:
        m = self._label_map("repro_batch_size_total", "size")
        return {int(s): c for s, c in m.items()}

    @property
    def deadline_met(self) -> Dict[str, int]:
        return self._label_map("repro_deadline_total", "tier", outcome="met")

    @property
    def deadline_missed(self) -> Dict[str, int]:
        return self._label_map("repro_deadline_total", "tier", outcome="missed")

    @property
    def deadline_flushes(self) -> int:
        return int(self._value("repro_deadline_flush_total"))

    @property
    def n_upserts(self) -> int:
        return int(self._value("repro_writes_total", op="upsert"))

    @property
    def n_deletes(self) -> int:
        return int(self._value("repro_writes_total", op="delete"))

    @property
    def n_compactions(self) -> int:
        return int(self._value("repro_compactions_total"))

    # ------------------------------------------------------------------
    def counters(self) -> Dict:
        """The deterministic ledger only (what replay tests compare)."""
        return {
            "n_completed": self.n_completed,
            "n_batches": self.n_batches,
            "plan_counts": dict(self.plan_counts),
            "backend_counts": dict(sorted(self.backend_counts.items())),
            "batch_sizes": dict(sorted(self.batch_sizes.items())),
            "deadline_met": dict(sorted(self.deadline_met.items())),
            "deadline_missed": dict(sorted(self.deadline_missed.items())),
            "deadline_flushes": self.deadline_flushes,
            "n_upserts": self.n_upserts,
            "n_deletes": self.n_deletes,
            "n_compactions": self.n_compactions,
            "fill_rate": round(float(np.mean(self._fill)) if self._fill else 0.0, 6),
            "mean_expansions": round(
                float(np.mean(self._expansions)) if self._expansions else 0.0, 6
            ),
        }

    def snapshot(self, backend=None) -> Dict:
        """Full state: deterministic counters + virtual latency quantiles
        (per tier and overall) + measured wall stats + the backend's cache
        counters when it exposes ``stats()`` (both engines do)."""
        all_lat = [x for xs in self._lat.values() for x in xs]
        out = dict(self.counters())
        out["latency_virtual"] = _quantiles(all_lat)
        out["latency_by_tier"] = {t: _quantiles(xs) for t, xs in sorted(self._lat.items())}
        out["queue_wait_virtual"] = _quantiles(self._queue_wait)
        out["wall"] = {
            "exec_s": self.wall_exec_s,
            "throughput_qps": (
                self.n_completed / self.wall_exec_s if self.wall_exec_s > 0 else 0.0
            ),
        }
        stats = getattr(backend, "stats", None)
        if callable(stats):
            out["engine"] = stats()
        return out
