"""The distribution layer's host parts; port of ``repro/dist``.

* :mod:`~repro_torch.dist.collectives` — the int8 all-reduces over
  ``torch.distributed`` (``compressed_psum``, ``psum_with_error_feedback``),
  the exact top-k shard merge and the DNF union merge (host numpy);
* :mod:`~repro_torch.dist.fault` — heartbeat and straggler monitors
  emitting :class:`FaultEvent` records;
* :mod:`~repro_torch.dist.elastic` — mesh replanning after host loss.

The reference's PartitionSpec rules (``dist/sharding.py``) are not ported
yet (ROADMAP Queue 1 item 13.2).
"""
from .collectives import compressed_psum, merge_topk, merge_topk_unique, psum_with_error_feedback
from .elastic import replan_mesh
from .fault import FaultEvent, HeartbeatMonitor, StragglerMitigator

__all__ = ["FaultEvent", "HeartbeatMonitor", "StragglerMitigator", "compressed_psum",
           "merge_topk", "merge_topk_unique", "psum_with_error_feedback", "replan_mesh"]
