"""Fair-share micro-batching: the runtime's event loop, fleet edition.

Port of ``repro/fleet/fairshare.py`` (copied).  ``FleetServiceModel``
keeps the reference's constants: virtual costs, not device times.

:class:`FleetRuntime` keeps the single-tenant discrete-event contract —
VIRTUAL clock, deterministic cost model, serial server, real engine
execution — and changes only who gets the batch slots:

* arrivals land in PER-TENANT queues (after the admission gate);
* a flush trigger (batch full / max-wait / deadline pressure) fires on
  the global state, exactly like ``OnlineRuntime``;
* batch slots are handed out by **deficit round-robin** over the tenant
  queues: each round every backlogged tenant earns ``weight`` credits
  and spends whole credits on queue slots, so over time tenants get
  batch share proportional to weight no matter how oversubscribed a
  noisy neighbor's queue is.  ``fair=False`` degrades to the shared
  single-queue baseline (tightest-deadline-first over ALL tenants) —
  the configuration the noisy-neighbor benchmark measures against;
* each tenant's slice of the batch executes on that tenant's OWN
  sharded engine, and its virtual service share divides by the
  tenant's live shard count (:class:`FleetServiceModel`) — which is
  what makes autoscaling effective in virtual time.

Everything that feeds batch composition — admission, DRR state,
deadlines, service times, autoscale decisions — derives from the trace
and deterministic models only, so the replay guarantee survives:
same multi-tenant trace + seed => identical per-tenant batch
compositions, result ids, and telemetry counters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.engine import PlannedResult
from ..runtime.queue import ArrivalTrace, RequestQueue, RuntimeRequest
from ..runtime.scheduler import ServiceModel
from .admission import AdmissionController
from .autoscale import AutoscaleConfig, FaultInjection, FleetAutoscaler, ScaleEvent
from .collections import Fleet
from .telemetry import FleetTelemetry

__all__ = ["FleetConfig", "FleetServiceModel", "FleetRuntime", "FleetReport"]


@dataclasses.dataclass
class FleetConfig:
    max_batch: int = 64        # pow2, as in the reference
    max_wait: float = 0.005    # virtual s the oldest request may age unflushed
    slo_slack: float = 0.0     # extra virtual s reserved when checking deadlines
    fair: bool = True          # False => shared-queue baseline (no isolation)

    def __post_init__(self):
        assert self.max_batch >= 1 and (self.max_batch & (self.max_batch - 1)) == 0, \
            "max_batch must be a power of two (as in the reference)"
        assert self.max_wait >= 0.0


@dataclasses.dataclass
class FleetServiceModel(ServiceModel):
    """The single-tenant cost model plus shard-parallel row service.

    A tenant's rows scan in parallel across its shards, so the per-row
    virtual cost divides by the tenant's live shard count; ``fanout``
    charges the per-shard dispatch + merge overhead so borrowing shards
    is never free.  Write costs stay undivided (a row lands on exactly
    one owning shard).  Fixed constants, like the base model: calibrating
    from wall time would break replay."""

    fanout: float = 1e-4       # per-shard overhead per tenant batch group

    def time_group(self, decisions, n_shards: int, n_upsert_rows: int = 0,
                   n_delete_rows: int = 0, n_compactions: int = 0) -> float:
        """One tenant's slice of a batch (NO dispatch — that is charged
        once per batch by the runtime)."""
        rows = float(sum(self.per_row[int(d)] for d in decisions))
        return (rows / max(n_shards, 1)
                + self.fanout * n_shards
                + n_upsert_rows * self.upsert_row
                + n_delete_rows * self.delete_row
                + n_compactions * self.compaction)

    def estimate_sharded(self, n_rows: int, n_shards: int) -> float:
        """Pessimistic pre-execution estimate for the deadline trigger."""
        return (self.dispatch
                + n_rows * max(self.per_row.values()) / max(n_shards, 1)
                + self.fanout * n_shards)


@dataclasses.dataclass
class FleetReport:
    """Everything a fleet trace replay produced, keyed for determinism
    checks: global batch compositions, per-rid results, rejected rids,
    and the fleet telemetry ledger (including scale events)."""

    results: Dict[int, PlannedResult]
    batches: List[List[int]]           # flush-order global-rid compositions
    rejected: List[int]                # rids shed at admission, arrival order
    telemetry: FleetTelemetry
    scale_events: List[ScaleEvent]

    def ids(self, rid: int) -> np.ndarray:
        return self.results[rid].result.ids[0]

    def slo_hit_rate(self, tenant: str) -> float:
        return self.telemetry.slo_hit_rate(tenant)


class FleetRuntime:
    """Deadline-aware fair-share micro-batching over a :class:`Fleet`.

    ``admission`` (optional) gates queries per tenant; ``autoscale``
    (optional :class:`AutoscaleConfig`) turns on the elastic router — a
    FRESH :class:`FleetAutoscaler` is built per run and the fleet's
    shard assignments reset to schema baselines at the top of every
    trace, so each replay starts from the same placement."""

    def __init__(self, fleet: Fleet, config: Optional[FleetConfig] = None,
                 service: Optional[FleetServiceModel] = None,
                 admission: Optional[AdmissionController] = None,
                 autoscale: Optional[AutoscaleConfig] = None,
                 faults: Optional[List[FaultInjection]] = None,
                 tracer=None):
        self.fleet = fleet
        self.config = config or FleetConfig()
        self.service = service or FleetServiceModel()
        self.admission = admission
        self.autoscale = autoscale
        self.faults = sorted(faults or [], key=lambda f: (f.t, f.tenant, f.shard))
        # optional repro_torch.obs.Tracer: installed on every tenant backend for
        # the run; per flushed batch one root span with per-tenant children
        self.tracer = tracer

    # ------------------------------------------------------------------
    def _next_flush(self, queues: Dict[str, RequestQueue], now: float):
        """(t_flush, deadline_pressure) over the global queue state: the
        max-wait trigger tracks the oldest request anywhere; the deadline
        trigger budgets each tenant's tightest deadline against THAT
        tenant's sharded service estimate."""
        cfg = self.config
        t_wait = np.inf
        t_slo = np.inf
        for name in self.fleet.names():
            q = queues[name]
            if not q:
                continue
            t_wait = min(t_wait, q.oldest_arrival + cfg.max_wait)
            est = self.service.estimate_sharded(
                min(len(q), cfg.max_batch), self.fleet[name].n_shards)
            t_slo = min(t_slo, q.tightest_deadline - est - cfg.slo_slack)
        return max(now, min(t_wait, t_slo)), t_slo <= t_wait

    def _drr_batch(self, queues: Dict[str, RequestQueue],
                   deficit: Dict[str, float], max_batch: int,
                   ) -> List[RuntimeRequest]:
        """Deficit round-robin in fixed tenant order: every backlogged
        tenant earns ``weight`` credits per round and spends whole credits
        on slots; an emptied queue forfeits its credit (classic DRR — no
        banking idle time).  Fractional weights accumulate across rounds,
        so weight ratios hold exactly in the long run."""
        batch: List[RuntimeRequest] = []
        names = self.fleet.names()
        while len(batch) < max_batch and any(queues[n] for n in names):
            for name in names:
                q = queues[name]
                if not q:
                    deficit[name] = 0.0
                    continue
                deficit[name] += self.fleet[name].weight
                while deficit[name] >= 1.0 and q and len(batch) < max_batch:
                    batch.extend(q.pop(1))
                    deficit[name] -= 1.0
                if len(batch) >= max_batch:
                    break
        return batch

    def _shared_batch(self, queues: Dict[str, RequestQueue], max_batch: int,
                      ) -> List[RuntimeRequest]:
        """The no-isolation baseline: one global tightest-deadline-first
        pool, exactly what ``OnlineRuntime`` does with a single queue."""
        items: List[RuntimeRequest] = []
        for name in self.fleet.names():
            q = queues[name]
            items.extend(q.pop(len(q)))
        items.sort(key=lambda r: r.priority)
        batch, rest = items[:max_batch], items[max_batch:]
        for r in rest:
            queues[r.tenant].push(r)
        return batch

    # ------------------------------------------------------------------
    def run_trace(self, trace: ArrivalTrace,
                  telemetry: Optional[FleetTelemetry] = None) -> FleetReport:
        """Replay one multi-tenant arrival trace to completion."""
        from ..obs.trace import NULL_TRACER

        cfg = self.config
        tel = telemetry or FleetTelemetry()
        tr = self.tracer if self.tracer is not None else NULL_TRACER
        if self.tracer is not None:
            for nm in self.fleet.names():
                backend = self.fleet[nm].backend
                if hasattr(backend, "set_tracer"):
                    backend.set_tracer(self.tracer)
        self.fleet.reset_shards()
        if self.admission is not None:
            self.admission.reset()
        scaler = (FleetAutoscaler(self.fleet, self.autoscale, telemetry=tel)
                  if self.autoscale is not None else None)
        names = self.fleet.names()
        queues: Dict[str, RequestQueue] = {n: RequestQueue() for n in names}
        deficit: Dict[str, float] = {n: 0.0 for n in names}
        for n in names:
            tel.tenant(n)           # idle tenants still appear in the ledger
        reqs = sorted(trace.requests, key=lambda r: (r.t_arrival, r.rid))
        results: Dict[int, PlannedResult] = {}
        batches: List[List[int]] = []
        rejected: List[int] = []

        def pending() -> int:
            return sum(len(q) for q in queues.values())

        def push(r: RuntimeRequest) -> None:
            if r.tenant not in queues:
                raise KeyError(f"trace request for unknown tenant {r.tenant!r}")
            if self.admission is not None and not self.admission.admit(r):
                rejected.append(r.rid)
                tel.record_reject(r.tenant)
                return
            queues[r.tenant].push(r)

        i = 0
        fi = 0             # next scripted fault to apply
        now = 0.0          # virtual clock
        busy_until = 0.0   # server is serial: next batch starts after this
        n = len(reqs)
        while i < n or pending():
            if not pending():
                now = max(now, reqs[i].t_arrival)
            while i < n and reqs[i].t_arrival <= now:
                push(reqs[i])
                i += 1
            now = max(now, busy_until) if pending() else now
            while i < n and reqs[i].t_arrival <= now:
                push(reqs[i])
                i += 1
            if not pending():
                continue       # everything admitted so far was shed
            deadline_flush = False
            if pending() < cfg.max_batch:
                t_flush, pressure = self._next_flush(queues, now)
                t_next = reqs[i].t_arrival if i < n else np.inf
                if t_next <= t_flush:
                    now = max(now, t_next)
                    continue
                now, deadline_flush = t_flush, pressure
            batch = (self._drr_batch(queues, deficit, cfg.max_batch) if cfg.fair
                     else self._shared_batch(queues, cfg.max_batch))
            batches.append([r.rid for r in batch])
            # execute per tenant group, in fixed tenant order: writes
            # before reads (rid order), reads grouped by k — the same
            # contract OnlineRuntime keeps, now per tenant engine
            groups = [(nm, [r for r in batch if r.tenant == nm]) for nm in names]
            service = self.service.dispatch
            executed = []      # (tenant, reads, res, n_up, n_del, n_comp, group_s)
            w0 = time.perf_counter()
            with tr.span("batch", n_rows=len(batch),
                         deadline_flush=bool(deadline_flush)):
                for nm, greqs in groups:
                    if not greqs:
                        continue
                    col = self.fleet[nm]
                    writes = sorted((r for r in greqs if r.op != "query"),
                                    key=lambda r: r.rid)
                    reads = [r for r in greqs if r.op == "query"]
                    with tr.span("tenant_group", tenant=nm,
                                 n_reads=len(reads), n_writes=len(writes)):
                        n_up = n_del = n_comp = 0
                        for r in writes:
                            if r.op == "upsert":
                                col.upsert(*r.payload)
                                n_up += len(r.payload[0])
                            else:
                                col.delete(*r.payload)
                                n_del += len(r.payload[0])
                        if writes and col.maybe_compact() is not None:
                            n_comp = 1
                        res: List[Optional[PlannedResult]] = [None] * len(reads)
                        if reads:
                            q = np.stack([r.query for r in reads]).astype(np.float32)
                            by_k: Dict[int, List[int]] = {}
                            for j, r in enumerate(reads):
                                by_k.setdefault(r.k, []).append(j)
                            for k, rows in by_k.items():
                                out = col.batch_query(
                                    q[rows], [reads[j].pred for j in rows], k)
                                for j, r in zip(rows, out):
                                    res[j] = r
                    group_s = self.service.time_group(
                        [r.decision for r in res], col.n_shards,
                        n_upsert_rows=n_up, n_delete_rows=n_del,
                        n_compactions=n_comp)
                    service += group_s
                    executed.append((nm, writes, reads, res, n_up, n_del,
                                     n_comp, group_s))
            wall = time.perf_counter() - w0
            t_complete = now + service
            busy_until = t_complete
            for nm, writes, reads, res, n_up, n_del, n_comp, group_s in executed:
                gtel = tel.tenant(nm)
                gtel.record_wall(wall * (group_s / service if service else 0.0))
                if writes:
                    gtel.record_writes(n_up, n_del, n_comp)
                if reads:
                    gtel.record_batch(reads, res, now, t_complete, deadline_flush)
                for r_req, r_res in zip(reads, res):
                    results[r_req.rid] = r_res
                if scaler is not None:
                    for r in reads:
                        scaler.observe(nm, t_complete <= r.deadline, t_complete)
                    scaler.beat(nm, t_complete, step_time=group_s)
            if scaler is not None:
                # scripted faults manifest once the virtual clock passes
                # them — replay-deterministic by construction
                while fi < len(self.faults) and self.faults[fi].t <= t_complete:
                    f = self.faults[fi]
                    if f.kind == "kill":
                        scaler.kill_shard(f.tenant, f.shard)
                    else:
                        scaler.slow_shard(f.tenant, f.shard, f.factor)
                    fi += 1
                scaler.step(t_complete)
        return FleetReport(results, batches, rejected, tel,
                           scaler.events if scaler is not None else [])
