"""The distribution layer; port of ``repro/dist``.

* :mod:`~repro_torch.dist.collectives` — the int8 all-reduces over
  ``torch.distributed`` (``compressed_psum``, ``psum_with_error_feedback``),
  the exact top-k shard merge and the DNF union merge (host numpy);
* :mod:`~repro_torch.dist.fault` — heartbeat and straggler monitors
  emitting :class:`FaultEvent` records;
* :mod:`~repro_torch.dist.elastic` — mesh replanning after host loss;
* :mod:`~repro_torch.dist.sharding` — parameter-name -> spec rules, and
  their DTensor placements for parameters, batches and decode caches on a
  ``DeviceMesh``;
* :mod:`~repro_torch.dist.tensor_parallel` — the model axis of a train
  step: the weights cut where the rules put them, split units between
  ``copy_to_model`` and ``reduce_from_model``, gathered weights, one
  all-reduce each.
"""
from .collectives import compressed_psum, merge_topk, merge_topk_unique, psum_with_error_feedback
from .elastic import replan_mesh
from .fault import FaultEvent, HeartbeatMonitor, StragglerMitigator
from .sharding import batch_sharding, cache_sharding, data_axes, param_sharding, param_spec

__all__ = ["FaultEvent", "HeartbeatMonitor", "StragglerMitigator", "batch_sharding",
           "cache_sharding", "compressed_psum", "data_axes", "merge_topk", "merge_topk_unique",
           "param_sharding", "param_spec", "psum_with_error_feedback", "replan_mesh"]
