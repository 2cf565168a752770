"""Command-line entry points and launch tools of the port.

``python -m repro_torch.launch.serve`` is the port of ``repro.launch.serve``
(LM generation and the trace-driven ANN runtime), ``python -m
repro_torch.launch.train`` of ``repro.launch.train`` (over a device mesh:
data-parallel, FSDP2), ``python -m repro_torch.launch.dryrun`` and
``python -m repro_torch.launch.report`` of the reference's dry-run and its
tables; ``mesh``, ``analytics`` and ``roofline`` are the modules they
share.  The dry-run is not imported here, as in the reference.
"""
from .mesh import make_production_mesh, make_local_mesh
from . import roofline

__all__ = ["make_production_mesh", "make_local_mesh", "roofline"]
