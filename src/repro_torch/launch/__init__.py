"""Command-line entry points of the port.

``python -m repro_torch.launch.serve`` is the port of ``repro.launch.serve``
(LM generation and the trace-driven ANN runtime), ``python -m
repro_torch.launch.train`` of ``repro.launch.train`` (one device).  The
reference's other launchers (``dryrun``, ``mesh``, ``roofline``,
``analytics``, ``report``) have no counterpart yet (ROADMAP Queue 1 item
13.2).
"""
