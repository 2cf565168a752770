"""Small shared numeric utilities for the core pipeline."""
from __future__ import annotations

import numpy as np

__all__ = ["next_pow2"]


def next_pow2(x: int, floor: int = 1) -> int:
    """Smallest power of two >= max(x, floor, 1).

    The pow2 rounding discipline is load-bearing in two places: jit'd shapes
    (subset/batch padding keeps the compile cache O(log N) x O(log B)) and
    batched execution grouping (post-filter budgets collapse into a handful
    of shared IVF dispatches).  One definition keeps every site agreeing.
    """
    x = max(int(x), int(floor), 1)
    return 1 << int(np.ceil(np.log2(x)))
