"""Fault machinery: dead-host and straggler detection.

Port of ``repro/dist/fault.py`` (host logic, copied).  A multi-process job
has no built-in failure detector: a dead host or shard hangs the next
collective.  The launch loop therefore runs two cheap host-side monitors
between steps and reacts (checkpoint + elastic replan, see
``dist.elastic``) *before* the hang:

* :class:`HeartbeatMonitor` — each host calls ``beat`` every step;
  ``check`` flags hosts whose last beat is older than ``timeout``.  A
  host is flagged **once** per death (no log spam while it stays down)
  and returns to the alive set if it beats again.
* :class:`StragglerMitigator` — tracks a per-host EMA of step wall time
  and flags hosts whose EMA exceeds ``threshold`` x the median of the
  other hosts (one-shot, like the heartbeat).  A consistent straggler
  gates every synchronous collective, so flagging at 2x is already late;
  ``min_observations`` suppresses cold-start noise (first steps include
  compilation).

Both emit :class:`FaultEvent` records for the launch loop (or the sharded
serving path's recovery, ``ShardedANNEngine.reshard``).
Detection is deliberately decoupled from mitigation: the monitors only
*observe*, the caller decides (re-mesh, drop host, alert).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

__all__ = ["FaultEvent", "HeartbeatMonitor", "StragglerMitigator"]


@dataclasses.dataclass
class FaultEvent:
    host: int
    step: int
    kind: str            # "dead_host" | "straggler"
    detail: str = ""

    def __str__(self) -> str:
        return f"[{self.kind}] host {self.host} at step {self.step}: {self.detail}"


class HeartbeatMonitor:
    """Dead-host detection from per-step heartbeats."""

    def __init__(self, n_hosts: int, timeout: float = 60.0):
        self.n_hosts = n_hosts
        self.timeout = timeout
        self._last: Dict[int, float] = {}
        self._flagged: set = set()

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self._last[host] = time.monotonic() if now is None else now
        self._flagged.discard(host)          # a beating host is alive again

    @property
    def alive(self) -> List[int]:
        return [h for h in range(self.n_hosts) if h not in self._flagged]

    def check(self, step: int, now: Optional[float] = None) -> List[FaultEvent]:
        now = time.monotonic() if now is None else now
        events = []
        for h in range(self.n_hosts):
            if h in self._flagged:
                continue
            # a host that has NEVER beaten is baselined at its first check —
            # dead-from-startup hosts get flagged one timeout later instead
            # of being invisible forever
            age = now - self._last.setdefault(h, now)
            if age > self.timeout:
                self._flagged.add(h)
                events.append(FaultEvent(
                    h, step, "dead_host",
                    f"no heartbeat for {age:.1f}s (timeout {self.timeout:.1f}s)",
                ))
        return events


class StragglerMitigator:
    """Per-host step-time EMA with threshold-based one-shot flagging."""

    def __init__(
        self,
        n_hosts: int,
        threshold: float = 2.0,
        decay: float = 0.8,
        min_observations: int = 8,
    ):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.decay = decay
        self.min_observations = min_observations
        self._ema: Dict[int, float] = {}
        self._count: Dict[int, int] = {}
        self._flagged: set = set()

    def record(self, host: int, step_time: float) -> None:
        prev = self._ema.get(host)
        self._ema[host] = (
            step_time if prev is None
            else self.decay * prev + (1.0 - self.decay) * step_time
        )
        self._count[host] = self._count.get(host, 0) + 1

    def check(self, step: int) -> List[FaultEvent]:
        seen = [h for h in self._ema if self._count[h] >= self.min_observations]
        events = []
        for h in seen:
            if h in self._flagged:
                continue
            others = sorted(self._ema[o] for o in seen if o != h)
            if not others:
                continue
            ref = others[len(others) // 2]       # median of the other hosts
            if ref > 0 and self._ema[h] > self.threshold * ref:
                self._flagged.add(h)
                events.append(FaultEvent(
                    h, step, "straggler",
                    f"step-time EMA {self._ema[h]:.3f}s vs median {ref:.3f}s "
                    f"(threshold {self.threshold:.1f}x)",
                ))
        return events
