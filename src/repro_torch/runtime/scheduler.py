"""Continuous micro-batcher over the batched plan->execute pipeline.

Port of ``repro/runtime/scheduler.py`` (copied).  ``ServiceModel`` keeps
the reference's constants: they are a fixed virtual cost model the replay
guarantee rests on, not measurements of this port on any device, and
every latency or deadline figure derived from them is virtual.

``OnlineRuntime`` drives a discrete-event loop in VIRTUAL time:

1. admit arrivals from the trace into the :class:`RequestQueue`;
2. form a micro-batch when a flush trigger fires — batch full
   (``max_batch``), oldest request waited ``max_wait``, or **deadline
   pressure**: the tightest pending deadline leaves no slack for the
   estimated service time, so tight-SLO requests preempt batch formation
   instead of waiting out ``max_wait`` behind bulk traffic;
3. execute the batch for real through ``backend.batch_query`` (the
   decision-grouped pipeline from ``core/engine.py``: one plan pass, one
   mask eval + fused top-k per distinct pre-filter predicate, shared IVF
   dispatches for the post group; ``max_batch`` must be a power of two,
   as in the reference, whose executors pad to pow2 — the port's do not
   pad, but the same configurations stay valid in both);
4. charge a deterministic virtual service time (:class:`ServiceModel`)
   against a serially-busy server, record telemetry, feed sampled
   outcomes to the planner feedback loop.

The split between real execution and virtual timing is the replay
guarantee: result ids are produced by the actual engine, but batch
composition and every latency/deadline statistic derive only from the
trace and the cost model — never from measured wall time — so the same
trace + seed reproduces the run bit-for-bit.  Measured wall time is
still tracked (``Telemetry.record_wall``) for throughput benchmarks; on a
CUDA device each batch's window closes after its device work, because
``batch_query`` returns host arrays.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.engine import PlannedResult
from ..core.planner import INDEXED_PRE, POST_FILTER, PRE_FILTER
from .queue import ArrivalTrace, RequestQueue
from .telemetry import Telemetry

__all__ = ["SchedulerConfig", "ServiceModel", "OnlineRuntime", "RuntimeReport"]


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 64        # pow2, as in the reference
    max_wait: float = 0.005    # virtual s the oldest request may age unflushed
    slo_slack: float = 0.0     # extra virtual s reserved when checking deadlines

    def __post_init__(self):
        assert self.max_batch >= 1 and (self.max_batch & (self.max_batch - 1)) == 0, \
            "max_batch must be a power of two (as in the reference)"
        assert self.max_wait >= 0.0


@dataclasses.dataclass
class ServiceModel:
    """Deterministic virtual service-time model for one micro-batch.

    ``dispatch`` is the fixed per-batch cost (planning + kernel launch);
    ``per_row`` charges each request by its planned decision (indexed
    pre-filtering is the cheapest path, the post-filter IVF probe sits in
    between, the columnar-scan pre-filter is the dearest).  The defaults
    are shaped like the measured 100k-fixture costs but deliberately
    FIXED constants: calibrating them from live measurements would leak
    wall-clock noise into batch composition and break replay.
    """

    dispatch: float = 2e-3
    per_row: Dict[int, float] = dataclasses.field(default_factory=lambda: {
        PRE_FILTER: 4e-4, POST_FILTER: 3e-4, INDEXED_PRE: 1.5e-4,
    })
    # live-corpus write costs (virtual s): per upserted/deleted row plus a
    # flat charge when a compaction (index rebuild) triggers inside a batch
    upsert_row: float = 2.5e-4
    delete_row: float = 1e-4
    compaction: float = 5e-2

    def time(self, decisions, n_upsert_rows: int = 0, n_delete_rows: int = 0,
             n_compactions: int = 0) -> float:
        return (self.dispatch
                + float(sum(self.per_row[int(d)] for d in decisions))
                + n_upsert_rows * self.upsert_row
                + n_delete_rows * self.delete_row
                + n_compactions * self.compaction)

    def estimate(self, n_rows: int) -> float:
        """Pessimistic pre-execution estimate (decisions unknown yet) —
        what the deadline-pressure trigger budgets with."""
        return self.dispatch + n_rows * max(self.per_row.values())


@dataclasses.dataclass
class RuntimeReport:
    """Everything a trace replay produced, keyed for determinism checks."""

    results: Dict[int, PlannedResult]          # rid -> planned result
    batches: List[List[int]]                   # flush-order batch compositions
    telemetry: Telemetry

    def ids(self, rid: int) -> np.ndarray:
        return self.results[rid].result.ids[0]


class OnlineRuntime:
    """Deadline-aware continuous micro-batching over a query backend.

    ``backend`` is anything with ``batch_query(queries, preds, k) ->
    List[PlannedResult]`` — the flat :class:`FilteredANNEngine` or the
    sharded :class:`ShardedANNEngine` fan-out.  ``feedback`` (optional) is
    an :class:`OnlineFeedback` loop observing sampled outcomes and
    refitting the planner between batches.  ``tracer`` (optional,
    :class:`repro_torch.obs.Tracer`) is installed on the backend for the run:
    each flushed micro-batch opens a root ``batch`` span over the
    backend's plan/execute/write spans.  ``probe`` (optional,
    :class:`repro_torch.obs.RecallProbe`) races a seeded sample of served reads
    against the exact oracle; its backend defaults to this runtime's.
    """

    def __init__(self, backend, config: Optional[SchedulerConfig] = None,
                 service: Optional[ServiceModel] = None, feedback=None,
                 tracer=None, probe=None):
        self.backend = backend
        self.config = config or SchedulerConfig()
        self.service = service or ServiceModel()
        self.feedback = feedback
        self.tracer = tracer
        self.probe = probe
        if probe is not None and probe.backend is None:
            probe.backend = backend

    # ------------------------------------------------------------------
    def _next_flush(self, queue: RequestQueue, now: float):
        """(t_flush, deadline_pressure): the earliest virtual time a flush
        trigger fires for the current queue, evaluated deterministically."""
        cfg = self.config
        t_wait = queue.oldest_arrival + cfg.max_wait
        t_slo = queue.tightest_deadline - self.service.estimate(
            min(len(queue), cfg.max_batch)) - cfg.slo_slack
        return max(now, min(t_wait, t_slo)), t_slo <= t_wait

    def run_trace(self, trace: ArrivalTrace, telemetry: Optional[Telemetry] = None,
                  ) -> RuntimeReport:
        """Replay one arrival trace to completion."""
        from ..obs.trace import NULL_TRACER

        cfg = self.config
        tel = telemetry or Telemetry()
        tr = self.tracer if self.tracer is not None else NULL_TRACER
        if self.tracer is not None and hasattr(self.backend, "set_tracer"):
            self.backend.set_tracer(self.tracer)
        queue = RequestQueue()
        reqs = sorted(trace.requests, key=lambda r: (r.t_arrival, r.rid))
        results: Dict[int, PlannedResult] = {}
        batches: List[List[int]] = []
        i = 0
        now = 0.0          # virtual clock
        busy_until = 0.0   # server is serial: next batch starts after this
        n = len(reqs)
        while i < n or queue:
            if not queue:
                now = max(now, reqs[i].t_arrival)
            while i < n and reqs[i].t_arrival <= now:
                queue.push(reqs[i])
                i += 1
            # the server frees at busy_until; nothing can flush before that
            now = max(now, busy_until) if queue else now
            while i < n and reqs[i].t_arrival <= now:
                queue.push(reqs[i])
                i += 1
            deadline_flush = False
            if len(queue) < cfg.max_batch:
                t_flush, pressure = self._next_flush(queue, now)
                t_next = reqs[i].t_arrival if i < n else np.inf
                if t_next <= t_flush:
                    # an arrival lands before any trigger: admit it first
                    now = max(now, t_next)
                    continue
                now, deadline_flush = t_flush, pressure
            batch = queue.pop(cfg.max_batch)
            rids = [r.rid for r in batch]
            batches.append(rids)
            # writes apply BEFORE this batch's reads (rid order within the
            # batch — deterministic), so a read flushed alongside a delete
            # already sees the tombstone; compaction runs through the
            # backend's own churn policy, never on a wall clock
            writes = sorted((r for r in batch if r.op != "query"),
                            key=lambda r: r.rid)
            reads = [r for r in batch if r.op == "query"]
            n_up = n_del = n_comp = 0
            w0 = time.perf_counter()
            res: List[Optional[PlannedResult]] = [None] * len(reads)
            with tr.span("batch", n_reads=len(reads), n_writes=len(writes),
                         deadline_flush=bool(deadline_flush)):
                for r in writes:
                    if r.op == "upsert":
                        self.backend.upsert(*r.payload)
                        n_up += len(r.payload[0])
                    else:
                        self.backend.delete(*r.payload)
                        n_del += len(r.payload[0])
                if writes and self.backend.maybe_compact() is not None:
                    n_comp = 1
                if reads:
                    q = np.stack([r.query for r in reads]).astype(np.float32)
                    # the trace generators emit one k per trace; grouping by
                    # k here keeps mixed-k traces correct without
                    # complicating composition
                    by_k: Dict[int, List[int]] = {}
                    for j, r in enumerate(reads):
                        by_k.setdefault(r.k, []).append(j)
                    for k, rows in by_k.items():
                        out = self.backend.batch_query(
                            q[rows], [reads[j].pred for j in rows], k)
                        for j, r in zip(rows, out):
                            res[j] = r
            tel.record_wall(time.perf_counter() - w0)
            service = self.service.time(
                [r.decision for r in res],
                n_upsert_rows=n_up, n_delete_rows=n_del, n_compactions=n_comp,
            )
            t_complete = now + service
            busy_until = t_complete
            if writes:
                tel.record_writes(n_up, n_del, n_comp)
            if reads:
                tel.record_batch(reads, res, now, t_complete, deadline_flush)
            for r_req, r_res in zip(reads, res):
                results[r_req.rid] = r_res
            if self.probe is not None:
                # oracle races run OUTSIDE the batch span: probing is
                # observability overhead, not serving work
                for r_req, r_res in zip(reads, res):
                    self.probe.observe(r_req, r_res)
            if self.feedback is not None:
                for r_req, r_res in zip(reads, res):
                    self.feedback.observe(r_req, r_res)
                self.feedback.maybe_refit()
        return RuntimeReport(results, batches, tel)
