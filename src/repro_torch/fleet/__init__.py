"""repro_torch.fleet — multi-tenant fleet serving over shared hardware.

Port of ``repro/fleet``, with the same public names.  On one card the
fleet's ``total_shards`` is a logical budget: a tenant's shards are views
of its engine's device corpus.

Scales the single-tenant ``repro_torch.runtime`` to many named collections
(redisvl-style schemas) served from one process without letting a noisy
neighbor starve the quiet tenants:

* ``collections`` — :class:`CollectionSchema` / :class:`TenantCollection`
  / :class:`Fleet`: each tenant wraps its own ``FilteredANNEngine`` +
  ``ShardedANNEngine`` (predicate/plan caches therefore partition
  per-tenant for free), with an SLO tier, a fair-share weight, and a
  shard assignment; fleet manifests checkpoint per-tenant generations.
* ``admission`` — per-tenant token buckets refilled in VIRTUAL time;
  over-budget queries are rejected at arrival (deterministically, by
  rid) instead of queueing behind everyone else's deadline.
* ``fairshare`` — :class:`FleetRuntime`, the runtime's discrete-event loop
  extended with per-tenant queues drained by deficit round-robin, so
  batch formation respects tenant weights while keeping the virtual/real
  replay guarantee (same trace + seed => identical batch compositions,
  result ids, telemetry counters).
* ``autoscale`` — grows/shrinks per-tenant shard assignments with
  ``dist.elastic.replan_mesh`` when sustained deadline misses cross
  thresholds, and recovers dead shards flagged by the ``dist.fault``
  monitors; every scale event is virtual-clock-stamped.
* ``telemetry`` — per-tenant plan/backend mix, SLO hit-rate, admission
  rejects, and scale events in one deterministic ledger.
"""
from .admission import AdmissionController, TokenBucket
from .autoscale import AutoscaleConfig, FaultInjection, FleetAutoscaler, ScaleEvent
from .collections import CollectionSchema, FieldSpec, Fleet, TenantCollection
from .fairshare import FleetConfig, FleetReport, FleetRuntime, FleetServiceModel
from .telemetry import FleetTelemetry

__all__ = [
    "FieldSpec",
    "CollectionSchema",
    "TenantCollection",
    "Fleet",
    "TokenBucket",
    "AdmissionController",
    "AutoscaleConfig",
    "ScaleEvent",
    "FaultInjection",
    "FleetAutoscaler",
    "FleetConfig",
    "FleetServiceModel",
    "FleetRuntime",
    "FleetReport",
    "FleetTelemetry",
]
