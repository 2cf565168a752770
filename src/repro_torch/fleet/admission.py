"""Per-tenant admission control: token buckets in VIRTUAL time.

Port of ``repro/fleet/admission.py`` (copied).

Load shedding beats load queueing when deadlines are tight: a request
that would wait out its SLO in the queue costs service capacity and
still misses.  Each tenant gets a token bucket sized to its budget
(``CollectionSchema.admit_rate``/``admit_burst`` or the controller
defaults); a query arriving with an empty bucket is REJECTED at
admission — it never enters a queue, never occupies a batch slot, and
the tenants inside their budget keep their deadlines.

Determinism: buckets refill from request ARRIVAL timestamps, not from
the scheduler's clock position, and the runtime admits requests in
(t_arrival, rid) order — so the admit/reject outcome for every rid is a
pure function of the trace, independent of batch formation.  Same trace
+ seed => the same rejects, every replay.

Writes are never shed: dropping an upsert/delete silently loses data,
so mutations always pass (they are batch-tier and cheap; backpressure
for writes is a compaction-policy concern, not an admission one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["TokenBucket", "AdmissionController"]


@dataclasses.dataclass
class TokenBucket:
    """Classic leaky bucket on the virtual clock: ``rate`` tokens/s refill
    capped at ``burst``; one token per admitted query."""

    rate: float
    burst: float
    tokens: float = dataclasses.field(default=None)  # type: ignore[assignment]
    t_last: float = 0.0

    def __post_init__(self):
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError(
                f"rate and burst must be > 0, got rate={self.rate} burst={self.burst}")
        if self.tokens is None:
            self.tokens = self.burst          # start full

    def try_take(self, now: float, cost: float = 1.0) -> bool:
        """Refill to ``now`` (monotone within a trace) and take ``cost``
        tokens if available."""
        if now > self.t_last:
            self.tokens = min(self.burst, self.tokens + (now - self.t_last) * self.rate)
            self.t_last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def reset(self) -> None:
        self.tokens = self.burst
        self.t_last = 0.0


class AdmissionController:
    """Admit/reject gate over per-tenant :class:`TokenBucket` budgets.

    Tenants without a configured budget (and the single-tenant ``""``
    tag) are always admitted — admission is opt-in per schema, so a
    fleet can protect itself from one noisy tenant without rate-limiting
    anyone else."""

    def __init__(self, budgets: Dict[str, Tuple[float, float]]):
        self.buckets: Dict[str, TokenBucket] = {
            t: TokenBucket(rate, burst) for t, (rate, burst) in budgets.items()}
        self.admitted: Dict[str, int] = {}
        self.rejected: Dict[str, int] = {}

    @classmethod
    def for_fleet(cls, fleet, default_rate: Optional[float] = None,
                  default_burst: Optional[float] = None) -> "AdmissionController":
        """Budgets from the fleet's schemas: per-tenant ``admit_rate`` wins,
        else ``default_rate`` (None leaves that tenant un-gated); burst
        defaults to one virtual second of rate."""
        budgets: Dict[str, Tuple[float, float]] = {}
        for col in fleet:
            s = col.schema
            rate = s.admit_rate if s.admit_rate is not None else default_rate
            if rate is None:
                continue
            burst = s.admit_burst if s.admit_burst is not None else (
                default_burst if default_burst is not None else rate)
            budgets[s.name] = (float(rate), float(burst))
        return cls(budgets)

    # ------------------------------------------------------------------
    def admit(self, req) -> bool:
        """Gate one request at its arrival time.  Mutations always pass."""
        tenant = getattr(req, "tenant", "")
        bucket = self.buckets.get(tenant)
        if bucket is None or req.op != "query":
            self.admitted[tenant] = self.admitted.get(tenant, 0) + 1
            return True
        if bucket.try_take(req.t_arrival):
            self.admitted[tenant] = self.admitted.get(tenant, 0) + 1
            return True
        self.rejected[tenant] = self.rejected.get(tenant, 0) + 1
        return False

    def reset(self) -> None:
        """Fresh buckets + counters — called at the top of every trace run
        so replays start from identical admission state."""
        for b in self.buckets.values():
            b.reset()
        self.admitted.clear()
        self.rejected.clear()

    def counters(self) -> Dict[str, Dict[str, int]]:
        return {"admitted": dict(sorted(self.admitted.items())),
                "rejected": dict(sorted(self.rejected.items()))}
