"""Elastic per-tenant shard scaling driven by SLO pressure + fault monitors.

Port of ``repro/fleet/autoscale.py`` (copied), over the port's
``dist.fault`` and ``dist.elastic``.  On one card a grow, shrink or
recovery reshards the tenant's engine: its shards are rebuilt as views of
its device corpus, each with its own IVF.

The router moves each tenant's shard assignment inside the fleet's
shared budget:

* **grow** — a tenant whose recent deadline miss-rate stays above
  ``grow_miss_rate`` borrows a shard (per-row service cost divides by
  the shard count — see ``fairshare.FleetServiceModel``), as long as
  the fleet budget has one free;
* **shrink** — a tenant coasting under ``shrink_miss_rate`` releases a
  shard back to the pool (never below ``min_shards``);
* **recover** — the ``dist.fault`` monitors watch per-shard liveness:
  a shard that stops heartbeating (``HeartbeatMonitor``) or whose
  synthetic step-time EMA flags it as a straggler
  (``StragglerMitigator``) is dropped by resharding the tenant onto the
  survivors — exact top-k merges are partition-independent, so results
  stay correct over the remaining shards.

Every new assignment is validated through ``dist.elastic.replan_mesh``
(one data-axis slot per shard, model axis pinned at 1) and recorded as
a :class:`ScaleEvent` stamped with the VIRTUAL clock — the monitors are
fed virtual time, so scale decisions replay bit-for-bit with the trace.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ..dist.elastic import replan_mesh
from ..dist.fault import HeartbeatMonitor, StragglerMitigator

__all__ = ["AutoscaleConfig", "ScaleEvent", "FaultInjection", "FleetAutoscaler"]


@dataclasses.dataclass
class AutoscaleConfig:
    eval_every: float = 0.5          # virtual s between policy evaluations
    grow_miss_rate: float = 0.20     # window miss-rate that triggers a grow
    shrink_miss_rate: float = 0.02   # miss-rate below which a shard releases
    min_window: int = 16             # completions needed before a verdict
    cooldown: float = 1.0            # virtual s between scale events per tenant
    min_shards: int = 1
    heartbeat_timeout: float = 0.5   # virtual s without a beat => dead shard
    straggler_threshold: float = 2.0
    straggler_min_obs: int = 8

    def __post_init__(self):
        assert self.eval_every > 0 and self.cooldown >= 0
        assert 0.0 <= self.shrink_miss_rate <= self.grow_miss_rate <= 1.0
        assert self.min_shards >= 1


@dataclasses.dataclass(frozen=True)
class FaultInjection:
    """A scripted, virtual-clock-scheduled shard fault — how tests and
    benchmarks exercise the recovery path deterministically mid-trace
    (``FleetRuntime(faults=[...])`` applies each one when the virtual
    clock passes ``t``)."""

    t: float                         # virtual time the fault manifests
    tenant: str
    shard: int
    kind: str = "kill"               # "kill" | "slow"
    factor: float = 4.0              # slow-only: step-time inflation


@dataclasses.dataclass
class ScaleEvent:
    """One replay-deterministic scale decision, virtual-clock-stamped."""

    t: float                         # virtual time of the decision
    tenant: str
    action: str                      # "grow" | "shrink" | "recover"
    from_shards: int
    to_shards: int
    reason: str
    mesh: Tuple[int, ...]            # replanned (data, model) mesh shape

    def as_dict(self) -> dict:
        return {"t": round(self.t, 6), "tenant": self.tenant,
                "action": self.action, "from_shards": self.from_shards,
                "to_shards": self.to_shards, "reason": self.reason,
                "mesh": list(self.mesh)}


class _TenantState:
    """Per-tenant scaling state: SLO window + fault monitors."""

    def __init__(self, n_shards: int, cfg: AutoscaleConfig):
        self.met = 0
        self.missed = 0
        self.last_scale = -float("inf")
        self.last_bucket = -1
        self.killed: Set[int] = set()
        self.slow: Dict[int, float] = {}
        self.new_monitors(n_shards, cfg)

    def new_monitors(self, n_shards: int, cfg: AutoscaleConfig) -> None:
        """Fresh monitors after any reshard — shard identities are
        positional, so the old liveness state is meaningless."""
        self.heartbeat = HeartbeatMonitor(n_shards, timeout=cfg.heartbeat_timeout)
        self.straggler = StragglerMitigator(
            n_shards, threshold=cfg.straggler_threshold,
            min_observations=cfg.straggler_min_obs)
        self.killed.clear()
        self.slow.clear()

    def reset_window(self) -> None:
        self.met = 0
        self.missed = 0

    @property
    def window(self) -> int:
        return self.met + self.missed


class FleetAutoscaler:
    def __init__(self, fleet, config: Optional[AutoscaleConfig] = None,
                 telemetry=None):
        self.fleet = fleet
        self.config = config or AutoscaleConfig()
        self.telemetry = telemetry
        self.events: List[ScaleEvent] = []
        self._states: Dict[str, _TenantState] = {
            col.name: _TenantState(col.n_shards, self.config) for col in fleet}
        self._step = 0

    # -- fault-injection hooks (tests/benchmarks) ----------------------
    def kill_shard(self, tenant: str, shard: int) -> None:
        """Stop the shard's heartbeats — the monitor flags it one timeout
        later and :meth:`step` reshards onto the survivors."""
        self._states[tenant].killed.add(shard)

    def slow_shard(self, tenant: str, shard: int, factor: float = 4.0) -> None:
        """Inflate the shard's synthetic step time so the straggler EMA
        crosses the threshold after ``straggler_min_obs`` batches."""
        self._states[tenant].slow[shard] = factor

    # -- runtime feed --------------------------------------------------
    def observe(self, tenant: str, met: bool, now: float) -> None:
        st = self._states[tenant]
        if met:
            st.met += 1
        else:
            st.missed += 1

    def beat(self, tenant: str, now: float, step_time: float = 1e-3) -> None:
        """One serviced batch for ``tenant``: every live shard heartbeats
        and reports a (deterministic, synthetic) per-shard step time —
        killed shards stay silent, slowed shards report inflated times."""
        st = self._states[tenant]
        n = self.fleet[tenant].n_shards
        for si in range(n):
            if si in st.killed:
                continue
            st.heartbeat.beat(si, now)
            st.straggler.record(si, step_time * st.slow.get(si, 1.0))

    # -- policy --------------------------------------------------------
    def _apply(self, tenant: str, new_n: int, action: str, reason: str,
               now: float) -> ScaleEvent:
        col = self.fleet[tenant]
        st = self._states[tenant]
        old_n = col.n_shards
        mesh_shape, _ = replan_mesh(new_n, model_parallel=1)
        col.reshard(new_n)
        st.new_monitors(new_n, self.config)
        st.last_scale = now
        st.reset_window()
        ev = ScaleEvent(now, tenant, action, old_n, new_n, reason, mesh_shape)
        self.events.append(ev)
        if self.telemetry is not None:
            self.telemetry.record_scale(ev)
        return ev

    def step(self, now: float) -> List[ScaleEvent]:
        """Evaluate every tenant at ``now`` (virtual).  Fault recovery
        preempts the SLO policy: a tenant with flagged shards reshards
        onto the survivors immediately, cooldown or not."""
        cfg = self.config
        self._step += 1
        out: List[ScaleEvent] = []
        for name in self.fleet.names():
            col = self.fleet[name]
            st = self._states[name]
            faults = st.heartbeat.check(self._step, now) + st.straggler.check(self._step)
            if faults:
                n_bad = len({f.host for f in faults})
                new_n = max(cfg.min_shards, col.n_shards - n_bad)
                if new_n != col.n_shards:
                    out.append(self._apply(
                        name, new_n, "recover", str(faults[0]), now))
                    continue
            bucket = int(now // cfg.eval_every)
            if bucket <= st.last_bucket:
                continue
            st.last_bucket = bucket
            if st.window < cfg.min_window or now - st.last_scale < cfg.cooldown:
                st.reset_window()
                continue
            miss_rate = st.missed / st.window
            if (miss_rate >= cfg.grow_miss_rate
                    and self.fleet.shards_in_use < self.fleet.total_shards):
                out.append(self._apply(
                    name, col.n_shards + 1, "grow",
                    f"miss_rate {miss_rate:.3f} >= {cfg.grow_miss_rate}", now))
            elif (miss_rate <= cfg.shrink_miss_rate
                    and col.n_shards > cfg.min_shards):
                out.append(self._apply(
                    name, col.n_shards - 1, "shrink",
                    f"miss_rate {miss_rate:.3f} <= {cfg.shrink_miss_rate}", now))
            else:
                st.reset_window()
        return out
