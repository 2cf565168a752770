"""The distribution layer's host parts; port of ``repro/dist``.

* :mod:`~repro_torch.dist.collectives` — the exact top-k shard merge and
  the DNF union merge (host numpy);
* :mod:`~repro_torch.dist.fault` — heartbeat and straggler monitors
  emitting :class:`FaultEvent` records;
* :mod:`~repro_torch.dist.elastic` — mesh replanning after host loss.

The reference's int8 all-reduces and its PartitionSpec rules belong to the
training path, which is not ported yet.
"""
from .collectives import merge_topk, merge_topk_unique
from .elastic import replan_mesh
from .fault import FaultEvent, HeartbeatMonitor, StragglerMitigator

__all__ = ["FaultEvent", "HeartbeatMonitor", "StragglerMitigator", "merge_topk",
           "merge_topk_unique", "replan_mesh"]
