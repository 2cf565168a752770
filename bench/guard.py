"""The check that a run loaded neither JAX nor the JAX package.

Module names are compared by their top-level part (before the first dot),
as whole words: ``repro_torch`` is the program under test, ``repro`` is
the JAX package it was ported from.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
