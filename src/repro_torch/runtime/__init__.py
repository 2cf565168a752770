"""repro_torch.runtime — deadline-aware online serving runtime.

Port of ``repro/runtime``, with the same public names.  The virtual cost
model (``ServiceModel``, ``SLO_TIERS``) keeps the reference's constants, so
batches form as the reference's do; nothing derived from it is an H100
time.

The asynchronous/streaming layer over the batched plan->execute pipeline:
arrival traces with per-request SLO deadlines (``queue``), a continuous
micro-batcher that drains them into decision-grouped batches under a
max-wait/max-batch/deadline-pressure policy (``scheduler``), per-request
and cache telemetry with a snapshot API (``telemetry``), and the online
planner feedback loop that refits ``CorePlanner`` from sampled live
outcomes behind a holdout-AUC drift guard (``feedback``).

Timing is VIRTUAL (discrete-event simulation over a deterministic cost
model) while execution is real — so a trace replays bit-for-bit (same
trace + seed => identical batch compositions, result ids, telemetry
counters) and still measures genuine engine throughput.
"""
from .queue import (
    SLO_TIERS,
    ArrivalTrace,
    RequestQueue,
    RuntimeRequest,
    TenantTraceSpec,
    bursty_trace,
    make_trace,
    multi_tenant_trace,
    poisson_trace,
)
from .scheduler import OnlineRuntime, RuntimeReport, SchedulerConfig, ServiceModel
from .telemetry import Telemetry
from .feedback import FeedbackConfig, LogEntry, OnlineFeedback

__all__ = [
    "SLO_TIERS",
    "RuntimeRequest",
    "ArrivalTrace",
    "RequestQueue",
    "poisson_trace",
    "bursty_trace",
    "make_trace",
    "TenantTraceSpec",
    "multi_tenant_trace",
    "SchedulerConfig",
    "ServiceModel",
    "OnlineRuntime",
    "RuntimeReport",
    "Telemetry",
    "FeedbackConfig",
    "LogEntry",
    "OnlineFeedback",
]
