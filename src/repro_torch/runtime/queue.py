"""Simulated-clock request queue + arrival-trace generators.

Port of ``repro/runtime/queue.py`` (copied): the generators draw from the
same seeded numpy streams in the same order, so a trace from a seed equals
the reference's bit for bit (arrivals, rids, ops, tiers, predicate picks).

The serving runtime is a discrete-event simulation over a VIRTUAL clock:
requests carry arrival timestamps and absolute deadlines, the scheduler
(`runtime/scheduler.py`) advances time deterministically, and service
durations come from a deterministic cost model.  Real engine execution
still happens (result ids are real), but nothing about *when* things
happen depends on wall-clock measurement — which is what makes a trace
replayable bit-for-bit: same trace + seed => identical batch compositions,
result ids, and telemetry counters.

Trace generators (all seeded):

* :func:`poisson_trace` — memoryless arrivals at a target rate, the
  steady-traffic baseline.
* :func:`bursty_trace`  — on/off modulated Poisson (bursts of
  ``burst_factor`` x the base rate), the flash-crowd shape.

Both draw predicates Zipf-distributed from a pool (a few hot filters
dominate — the regime the predicate cache and the batched pre-filter
group are designed for) and assign SLO tiers by a mix ratio; a tier maps
to a relative deadline (``SLO_TIERS``).

Multi-tenant streams (:func:`multi_tenant_trace`) interleave one seeded
per-tenant sub-trace per :class:`TenantTraceSpec` — each tenant keeps its
own shape, rate, tier mix, and (for the noisy-neighbor profile) burst
parameters — into ONE arrival stream with dense global rids, so the fleet
scheduler replays exactly like the single-tenant runtime does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.predicates import AnyPredicate

__all__ = [
    "SLO_TIERS",
    "RuntimeRequest",
    "ArrivalTrace",
    "RequestQueue",
    "TenantTraceSpec",
    "poisson_trace",
    "bursty_trace",
    "multi_tenant_trace",
    "make_trace",
]

# tier -> relative deadline in virtual seconds (arrival + deadline budget).
# Calibrated against ServiceModel's default costs: a full 64-batch serves in
# ~20 virtual ms, so "interactive" can only be met by early/small flushes —
# exactly the preemption behaviour the deadline-aware scheduler exists for.
SLO_TIERS: Dict[str, float] = {
    "interactive": 0.02,
    "standard": 0.10,
    "batch": 1.00,
}


@dataclasses.dataclass
class RuntimeRequest:
    """One in-flight filtered-ANN request in the serving runtime.

    ``op`` distinguishes reads ("query") from live-corpus writes ("upsert"
    / "delete"); writes carry their rows in ``payload`` (upsert:
    ``(vectors, cat, num)``; delete: ``(ids,)``) and a ``None`` query/pred.
    One queue serves both — writes are ordinary prioritised requests, so
    batch composition (and therefore replay) stays deterministic."""

    rid: int                      # unique, dense, trace order
    t_arrival: float              # virtual seconds
    query: Optional[np.ndarray]   # (d,) float32; None for writes
    pred: Optional[AnyPredicate]  # None for writes
    k: int
    tier: str = "standard"
    deadline: float = np.inf      # ABSOLUTE virtual time
    op: str = "query"             # "query" | "upsert" | "delete"
    payload: Optional[tuple] = None
    tenant: str = ""              # owning collection (fleet serving); ""
                                  # means the single-tenant runtime

    @property
    def priority(self):
        """Queue ordering key: tightest deadline first, FIFO within a
        deadline, rid as the total tie-break (determinism)."""
        return (self.deadline, self.t_arrival, self.rid)


@dataclasses.dataclass
class ArrivalTrace:
    """A replayable arrival stream: requests sorted by ``t_arrival``."""

    requests: List[RuntimeRequest]
    kind: str                      # "poisson" | "bursty"
    rate: float                    # mean arrival rate (virtual qps)
    seed: int

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)


class RequestQueue:
    """Pending-request pool with deadline-aware draining.

    Tiny on purpose: queues hold at most a few hundred requests between
    flushes, so a plain list + sort-on-pop is both fast enough and — unlike
    a heap with incidental tie handling — *obviously* deterministic, which
    the replay guarantee leans on.
    """

    def __init__(self):
        self._items: List[RuntimeRequest] = []

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def push(self, req: RuntimeRequest) -> None:
        self._items.append(req)

    @property
    def oldest_arrival(self) -> float:
        return min(r.t_arrival for r in self._items)

    @property
    def tightest_deadline(self) -> float:
        return min(r.deadline for r in self._items)

    def pop(self, n: int) -> List[RuntimeRequest]:
        """Remove and return the ``n`` highest-priority requests (tightest
        deadline first) — tight-SLO arrivals jump the whole queue."""
        self._items.sort(key=lambda r: r.priority)
        batch, self._items = self._items[:n], self._items[n:]
        return batch


# ----------------------------------------------------------------------
# trace generators
# ----------------------------------------------------------------------
def _check_fracs(write_frac: float, upsert_frac: float) -> None:
    """Trace-generator construction guard: a probability outside [0, 1]
    silently degenerates the write mix (numpy comparisons just saturate),
    so reject it loudly instead of emitting an unusable trace."""
    if not 0.0 <= write_frac <= 1.0:
        raise ValueError(f"write_frac must be in [0, 1], got {write_frac}")
    if not 0.0 <= upsert_frac <= 1.0:
        raise ValueError(f"upsert_frac must be in [0, 1], got {upsert_frac}")


def _assemble(
    arrivals: np.ndarray,
    queries: np.ndarray,
    preds: Sequence[AnyPredicate],
    k: int,
    tier_mix: Dict[str, float],
    zipf_a: float,
    rng: np.random.Generator,
    write_frac: float = 0.0,
    write_corpus: Optional[tuple] = None,
    delete_pool: Optional[np.ndarray] = None,
    upsert_frac: float = 0.5,
) -> List[RuntimeRequest]:
    n = arrivals.size
    # Zipf over the predicate pool: rank-r filter drawn with p ~ 1/r^a
    ranks = np.arange(1, len(preds) + 1, dtype=np.float64)
    p_pred = 1.0 / ranks**zipf_a
    p_pred /= p_pred.sum()
    pred_idx = rng.choice(len(preds), size=n, p=p_pred)
    q_idx = rng.integers(0, queries.shape[0], size=n)
    tiers = list(tier_mix)
    p_tier = np.asarray([tier_mix[t] for t in tiers], np.float64)
    p_tier /= p_tier.sum()
    tier_idx = rng.choice(len(tiers), size=n, p=p_tier)
    # interleaved writes: each slot flips write with prob write_frac, then
    # upsert vs delete with prob upsert_frac — all from the SAME seeded rng
    # as the read stream, so a (seed, write_frac) pair is fully replayable.
    is_write = (rng.random(n) < write_frac) if write_frac > 0 else np.zeros(n, bool)
    is_upsert = rng.random(n) < upsert_frac if write_frac > 0 else None
    wv = wc = wm = None
    if write_corpus is not None:
        wv, wc, wm = (np.atleast_2d(np.asarray(a)) for a in write_corpus)
    up_i = del_i = 0
    reqs = []
    for i in range(n):
        t = float(arrivals[i])
        if is_write[i]:
            # upsert when rows remain (cycling), else delete; fall back to
            # the other kind (or a plain query) when a source is missing
            do_up = bool(is_upsert[i]) if wv is not None else False
            if not do_up and (delete_pool is None or not len(delete_pool)):
                do_up = wv is not None
            if do_up:
                j = up_i % len(wv)
                up_i += 1
                payload = (wv[j:j + 1], wc[j:j + 1], wm[j:j + 1])
                op = "upsert"
            elif delete_pool is not None and len(delete_pool):
                did = int(delete_pool[del_i % len(delete_pool)])
                del_i += 1
                payload = (np.asarray([did], np.int64),)
                op = "delete"
            else:
                payload, op = None, "query"
            if op != "query":
                reqs.append(RuntimeRequest(
                    rid=i, t_arrival=t, query=None, pred=None, k=k,
                    tier="batch", deadline=t + SLO_TIERS["batch"],
                    op=op, payload=payload,
                ))
                continue
        tier = tiers[int(tier_idx[i])]
        reqs.append(RuntimeRequest(
            rid=i, t_arrival=t,
            query=queries[q_idx[i]], pred=preds[pred_idx[i]], k=k,
            tier=tier, deadline=t + SLO_TIERS[tier],
        ))
    return reqs


_DEFAULT_MIX = {"interactive": 0.2, "standard": 0.6, "batch": 0.2}


def poisson_trace(
    queries: np.ndarray,
    preds: Sequence[AnyPredicate],
    n_requests: int,
    rate: float,
    k: int = 10,
    tier_mix: Optional[Dict[str, float]] = None,
    zipf_a: float = 1.2,
    seed: int = 0,
    write_frac: float = 0.0,
    write_corpus: Optional[tuple] = None,
    delete_pool: Optional[np.ndarray] = None,
    upsert_frac: float = 0.5,
) -> ArrivalTrace:
    """Memoryless arrivals: exponential inter-arrival gaps at ``rate`` qps.

    ``write_frac > 0`` interleaves live-corpus writes into the stream:
    upserts draw rows (cycling) from ``write_corpus = (vectors, cat, num)``,
    deletes cycle through ``delete_pool`` handles."""
    _check_fracs(write_frac, upsert_frac)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    reqs = _assemble(arrivals, queries, preds, k, tier_mix or _DEFAULT_MIX,
                     zipf_a, rng, write_frac=write_frac,
                     write_corpus=write_corpus, delete_pool=delete_pool,
                     upsert_frac=upsert_frac)
    return ArrivalTrace(reqs, "poisson", rate, seed)


def bursty_trace(
    queries: np.ndarray,
    preds: Sequence[AnyPredicate],
    n_requests: int,
    rate: float,
    burst_factor: float = 8.0,
    burst_frac: float = 0.25,
    cycle: float = 0.25,
    k: int = 10,
    tier_mix: Optional[Dict[str, float]] = None,
    zipf_a: float = 1.2,
    seed: int = 0,
    write_frac: float = 0.0,
    write_corpus: Optional[tuple] = None,
    delete_pool: Optional[np.ndarray] = None,
    upsert_frac: float = 0.5,
) -> ArrivalTrace:
    """On/off modulated Poisson with mean rate ``rate``: a fraction
    ``burst_frac`` of each ``cycle`` runs at ``burst_factor`` x the off-rate
    (off-rate solved so the time-average stays ``rate``) — the flash-crowd
    shape that stresses queueing and deadline misses."""
    _check_fracs(write_frac, upsert_frac)
    rng = np.random.default_rng(seed)
    # rate_off * (1 - f + f * factor) = rate
    rate_off = rate / (1.0 - burst_frac + burst_frac * burst_factor)
    rate_on = rate_off * burst_factor
    arrivals = np.empty(n_requests)
    t = 0.0
    for i in range(n_requests):
        in_burst = (t % cycle) < burst_frac * cycle
        r = rate_on if in_burst else rate_off
        t += float(rng.exponential(1.0 / r))
        arrivals[i] = t
    reqs = _assemble(arrivals, queries, preds, k, tier_mix or _DEFAULT_MIX,
                     zipf_a, rng, write_frac=write_frac,
                     write_corpus=write_corpus, delete_pool=delete_pool,
                     upsert_frac=upsert_frac)
    return ArrivalTrace(reqs, "bursty", rate, seed)


def make_trace(kind: str, *args, **kwargs) -> ArrivalTrace:
    """Dispatch by shape name — what the CLI and the benchmarks use."""
    gen = {"poisson": poisson_trace, "bursty": bursty_trace}.get(kind)
    if gen is None:
        raise ValueError(f"unknown trace kind {kind!r} (poisson|bursty)")
    return gen(*args, **kwargs)


# ----------------------------------------------------------------------
# multi-tenant traces
# ----------------------------------------------------------------------
@dataclasses.dataclass
class TenantTraceSpec:
    """One tenant's slice of a multi-tenant arrival stream.

    ``kind="bursty"`` with a large ``burst_factor`` is the configurable
    noisy-neighbor profile: the tenant idles near its off-rate and slams
    ``burst_factor``x that rate for ``burst_frac`` of every ``cycle``
    (see :func:`bursty_trace` — the time-average stays ``rate``)."""

    tenant: str
    queries: np.ndarray
    preds: Sequence[AnyPredicate]
    n_requests: int
    rate: float                              # mean virtual qps for this tenant
    kind: str = "poisson"                    # "poisson" | "bursty"
    k: int = 10
    tier_mix: Optional[Dict[str, float]] = None
    zipf_a: float = 1.2
    burst_factor: float = 8.0                # bursty-only knobs
    burst_frac: float = 0.25
    cycle: float = 0.25


def multi_tenant_trace(
    specs: Sequence[TenantTraceSpec], seed: int = 0
) -> ArrivalTrace:
    """Interleave one seeded sub-trace per tenant into a single stream.

    Each spec generates through the ordinary single-tenant generators with
    its own derived seed (``seed + 1009 * index`` — stable under replay,
    distinct across tenants), every request is tagged with its tenant
    name, and the merged stream is re-numbered with dense global rids in
    ``(t_arrival, spec order, local rid)`` order so the scheduler's
    rid-based tie-breaks stay total and deterministic."""
    if not specs:
        raise ValueError("multi_tenant_trace needs at least one TenantTraceSpec")
    names = [s.tenant for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names in specs: {names}")
    tagged = []
    for si, spec in enumerate(specs):
        kw = dict(k=spec.k, tier_mix=spec.tier_mix, zipf_a=spec.zipf_a,
                  seed=seed + 1009 * si)
        if spec.kind == "bursty":
            kw.update(burst_factor=spec.burst_factor,
                      burst_frac=spec.burst_frac, cycle=spec.cycle)
        sub = make_trace(spec.kind, spec.queries, spec.preds,
                         spec.n_requests, spec.rate, **kw)
        for r in sub:
            tagged.append((r.t_arrival, si, r.rid, r))
    tagged.sort(key=lambda x: x[:3])
    reqs = [
        dataclasses.replace(r, rid=rid, tenant=specs[si].tenant)
        for rid, (_, si, _, r) in enumerate(tagged)
    ]
    total_rate = float(sum(s.rate for s in specs))
    return ArrivalTrace(reqs, "multi", total_rate, seed)
