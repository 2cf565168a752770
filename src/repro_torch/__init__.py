"""repro_torch — the filtered-ANN engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro``, laid out like it (``core``, ``filter``,
``index``, ``kernels``, ``data``) so that each module has one counterpart.
It imports torch and numpy only.  Entry points take a ``device`` (default
``"cuda"``, which raises when there is no card); ``device="cpu"`` runs the
kernels' plain PyTorch versions.
"""
