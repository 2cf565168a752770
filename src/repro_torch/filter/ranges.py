"""Sorted-order + equi-depth edge indexes answering interval predicates
as bitmaps — no O(N) columnar compare.

Per numeric attribute the index stores:

* ``order``  — the argsort permutation of the column,
* ``vals``   — the column sorted ascending, **kept in the column's own
  dtype**: the scan path evaluates ``x >= lo`` with Python-float bounds,
  which NumPy 2 weak promotion resolves in the COLUMN's dtype (the bound
  is rounded to float32 for float32 data).  ``interval_words`` therefore
  quantises each bound through that dtype before ``searchsorted``, so the
  index includes/excludes boundary rows exactly as the scan does,
* ``edges``  — B+1 equi-depth bucket boundaries in *position* space,
* ``cum_words`` — a (B+1, W) uint32 matrix of *cumulative* edge bitmaps:
  row i holds the rows at sorted positions ``[0, edges[i])``, so row 0 is
  empty and row B is every row.

An interval ``[lo, hi)`` maps to the sorted-position slice
``[left, right) = [searchsorted(vals, lo, "left"), searchsorted(vals, hi,
"left"))``.  Each cut snaps to its nearest edge, ``j0`` and ``j1``; the
rows at ``[edges[j0], edges[j1])`` are ``cum_words[j1] ^ cum_words[j0]``,
and the rows between each cut and its edge toggle by one XOR scatter (in
where the slice reaches past its edge, out where it stops short).  A slice
with fewer rows than those toggles packs directly: always so when both
cuts snap to one edge, where it is at most one bucket.  Total cost is
O(N/32) words plus at most half a bucket of rows per cut, where an OR over
the covered buckets' rows would cost O(B · N/32).  ``cut_rows`` counts the
rows packed at the cuts, for tracing.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .bitmap import empty_words, n_words, word_or, words_from_ids

__all__ = ["RangeIndex", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = 128


def _nearest_edges(edges: np.ndarray, *pos: int) -> np.ndarray:
    """Index of the edge nearest each sorted position (the lower on a tie)."""
    p = np.asarray(pos, dtype=np.int64)
    hi = np.searchsorted(edges, p, side="left")          # first edge >= p
    lo = np.maximum(hi - 1, 0)
    up = np.minimum(hi, edges.size - 1)
    return np.where(p - edges[lo] <= edges[up] - p, lo, up)


class RangeIndex:
    def __init__(self, n: int, orders: List[np.ndarray], vals: List[np.ndarray],
                 edges: List[np.ndarray], cum_words: List[np.ndarray]):
        self.n = n
        self._orders = orders
        self._vals = vals
        self._edges = edges
        self._cum_words = cum_words
        # rows packed one by one at interval cuts, summed over every call:
        # a tracer reads its delta across one compilation
        self.cut_rows = 0
        # Staleness under a live corpus: sorted orders and equi-depth bucket
        # boundaries CANNOT be extended incrementally (an appended value
        # lands anywhere in the sorted permutation), so a mutated attribute
        # fails CLOSED — ``fresh()`` goes False, the attribute drops out of
        # ``AttributeIndex.covers()``, and executors fall back to the
        # columnar scan instead of answering from pre-mutation buckets.
        self._stale = [False] * len(orders)

    @property
    def n_attrs(self) -> int:
        return len(self._orders)

    def fresh(self, attr: int) -> bool:
        """False once the corpus mutated under this attribute's buckets —
        callers must not consult the pre-mutation index for it."""
        return not self._stale[attr]

    def mark_stale(self) -> None:
        """Invalidate every attribute (appended rows carry values for all
        numeric columns).  A compaction rebuilds the index fresh."""
        self._stale = [True] * len(self._orders)

    @staticmethod
    def build(num: np.ndarray, n_buckets: int = DEFAULT_BUCKETS) -> "RangeIndex":
        num = np.asarray(num)
        n = num.shape[0] if num.ndim >= 2 else 0
        a_num = num.shape[1] if num.ndim >= 2 else 0
        orders, vals, edges, cum_words = [], [], [], []
        for j in range(a_num):
            col = num[:, j]
            order = np.argsort(col, kind="stable").astype(np.int64)
            sv = np.ascontiguousarray(col[order])   # column dtype preserved
            b = max(1, min(int(n_buckets), n)) if n else 1
            e = np.round(np.linspace(0, n, b + 1)).astype(np.int64)
            cw = np.zeros((b + 1, n_words(n)), dtype=np.uint32)
            for i in range(b):
                cw[i + 1] = word_or(cw[i], words_from_ids(order[e[i]:e[i + 1]], n))
            orders.append(order)
            vals.append(sv)
            edges.append(e)
            cum_words.append(cw)
        return RangeIndex(n, orders, vals, edges, cum_words)

    # ------------------------------------------------------------------
    def _cut(self, attr: int, bound: float) -> int:
        """Sorted position of the first value >= ``bound``, with the bound
        quantised exactly as the columnar scan's comparison would see it
        (Python-float bounds weak-promote to the column dtype)."""
        sv = self._vals[attr]
        if np.issubdtype(sv.dtype, np.floating):
            with np.errstate(over="ignore"):   # out-of-range bound -> +-inf,
                bound = sv.dtype.type(bound)   # exactly what the scan's cast does
        return int(np.searchsorted(sv, bound, side="left"))

    def interval_words(self, attr: int, lo: float, hi: float) -> np.ndarray:
        """Bitmap of ``lo <= x < hi`` over attribute ``attr`` (exact)."""
        if self.n == 0:
            return empty_words(0)
        order = self._orders[attr]
        left = self._cut(attr, lo)
        right = self._cut(attr, hi)
        if right <= left:
            return empty_words(self.n)
        e = self._edges[attr]
        j0, j1 = (int(j) for j in _nearest_edges(e, left, right))
        # the rows between each cut and its edge, toggled around the rows
        # [e[j0], e[j1]) of two cumulative rows
        a0, b0 = sorted((left, int(e[j0])))
        a1, b1 = sorted((right, int(e[j1])))
        if right - left <= (b0 - a0) + (b1 - a1):
            # always so when both cuts snap to one edge: at most one bucket
            self.cut_rows += right - left
            return words_from_ids(order[left:right], self.n)
        self.cut_rows += (b0 - a0) + (b1 - a1)
        cw = self._cum_words[attr]
        w = cw[j1] ^ cw[j0]
        ids = np.concatenate([order[a0:b0], order[a1:b1]])
        np.bitwise_xor.at(w, ids >> 5, np.uint32(1) << (ids & 31).astype(np.uint32))
        return w

    def union_words(self, attr: int, intervals: Sequence[Tuple[float, float]]) -> np.ndarray:
        """Bitmap of a union of intervals over one attribute.  ``RangePred``
        construction merges overlaps, so the union is a plain OR."""
        w = empty_words(self.n)
        for lo, hi in intervals:
            w = word_or(w, self.interval_words(attr, lo, hi))
        return w
