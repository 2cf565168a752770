"""Live recall probe: measured recall per (plan, backend, knob) class.

Port of ``repro/obs/probe.py`` (copied).  On a CUDA device the oracle,
``FilteredANNEngine.ground_truth``, scans on the card (``l2_topk`` on a
clean corpus, the masked top-k kernel on a live one).

The routing head promises ``route_recall_target`` recall on routed
traffic, but nothing measured it on LIVE queries — labels come from the
offline fit distribution.  The probe closes that gap: a seeded fraction
of served requests is raced against the exact masked top-k oracle
(``FilteredANNEngine.ground_truth``, the same machinery ``label_query``
uses), and per-class online recall estimates accumulate with confidence
counts.

Sampling is **per-rid**: ``default_rng([seed, rid])`` decides each
request independently of arrival order or batch composition, so which
requests get probed — and therefore every probe counter — replays
bit-for-bit (the oracle race itself is deterministic: result ids and
ground-truth ids both are).  The wall cost of the oracle is real, which
is why the probe samples instead of racing everything.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["RecallProbe"]


class RecallProbe:
    """Seeded-sampling online recall estimator.

    ``backend`` is anything with ``ground_truth(q, pred, k)`` or an
    ``engine`` attribute that has it (``ShardedANNEngine``); the runtime
    fills it in at ``run_trace`` time when left ``None``.  ``truth_fn``
    overrides the oracle entirely (tests inject known truths).
    """

    def __init__(self, backend=None, rate: float = 0.05, seed: int = 0,
                 truth_fn: Optional[Callable] = None):
        assert 0.0 <= rate <= 1.0
        self.backend = backend
        self.rate = float(rate)
        self.seed = int(seed)
        self.truth_fn = truth_fn
        self.n_seen = 0
        self.n_sampled = 0
        self._sum: Dict[str, float] = {}     # class key -> recall sum
        self._count: Dict[str, int] = {}     # class key -> samples

    # ------------------------------------------------------------------
    def should_sample(self, rid: int) -> bool:
        """Deterministic per-request coin flip, independent of order."""
        if self.rate >= 1.0:
            return True
        if self.rate <= 0.0:
            return False
        return bool(
            np.random.default_rng([self.seed, int(rid)]).random() < self.rate)

    @staticmethod
    def class_key(res) -> str:
        """(plan, backend, knob) key of a served PlannedResult — backends
        are always named by packaging (un-routed rows get the default
        (flat, exact)/(ivf, adapt) names)."""
        r = res.result
        return f"{r.strategy}/{r.backend}:{r.knob}"

    def _truth(self, query: np.ndarray, pred, k: int) -> np.ndarray:
        if self.truth_fn is not None:
            return np.asarray(self.truth_fn(query, pred, k))
        be = self.backend
        eng = getattr(be, "engine", be)      # sharded -> central engine
        return np.asarray(eng.ground_truth(query, pred, k))

    def observe(self, req, res) -> bool:
        """Called per served read request; returns True when it was probed.
        ``req`` is a RuntimeRequest, ``res`` its PlannedResult."""
        self.n_seen += 1
        if res is None or not self.should_sample(req.rid):
            return False
        from ..core.executors import recall_at_k

        truth = self._truth(np.atleast_2d(req.query), req.pred, req.k)
        rec = recall_at_k(res.result.ids, truth)
        key = self.class_key(res)
        self._sum[key] = self._sum.get(key, 0.0) + rec
        self._count[key] = self._count.get(key, 0) + 1
        self.n_sampled += 1
        return True

    # ------------------------------------------------------------------
    def estimates(self) -> Dict[str, Dict[str, Any]]:
        """Per-class ``{"recall": mean, "count": n}`` in sorted class
        order; fully deterministic under replay."""
        return {
            key: {"recall": round(self._sum[key] / self._count[key], 6),
                  "count": self._count[key]}
            for key in sorted(self._count)
        }

    def counters(self) -> Dict[str, Any]:
        """The probe's deterministic ledger (replay tests compare this)."""
        return {
            "rate": self.rate,
            "seed": self.seed,
            "n_seen": self.n_seen,
            "n_sampled": self.n_sampled,
            "classes": self.estimates(),
        }

    def publish(self, registry, **labels) -> None:
        """Export into a :class:`repro_torch.obs.metrics.MetricsRegistry`."""
        registry.set_gauge("repro_probe_seen_total", self.n_seen, **labels)
        registry.set_gauge("repro_probe_sampled_total", self.n_sampled, **labels)
        for key, row in self.estimates().items():
            registry.set_gauge("repro_probe_recall", row["recall"],
                               cls=key, **labels)
            registry.set_gauge("repro_probe_samples", row["count"],
                               cls=key, **labels)

    def below(self, floor: float) -> Dict[str, float]:
        """Classes whose measured online recall sits under ``floor`` —
        the drift-guard hook (feed these to the feedback loop / alerts)."""
        return {
            key: row["recall"]
            for key, row in self.estimates().items()
            if row["recall"] < floor
        }
