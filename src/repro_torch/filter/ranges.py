"""Sorted-order + equi-depth bucket indexes answering interval predicates
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
* ``bucket_words`` — a (B, W) uint32 matrix: bucket b's precomputed bitmap
  of the rows at sorted positions ``[edges[b], edges[b+1])``.

An interval ``[lo, hi)`` maps to the sorted-position slice
``[searchsorted(vals, lo, "left"), searchsorted(vals, hi, "left"))``; the
fully covered buckets OR together via one vectorised reduce over the
precomputed rows, and only the two partial boundary slices (at most one
bucket's worth of rows each) pack individually.  Total cost is
O(B · N/32 + N/B) words versus the scan's O(N) float compares.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .bitmap import empty_words, n_words, word_or, words_from_ids

__all__ = ["RangeIndex", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = 128


class RangeIndex:
    def __init__(self, n: int, orders: List[np.ndarray], vals: List[np.ndarray],
                 edges: List[np.ndarray], bucket_words: List[np.ndarray]):
        self.n = n
        self._orders = orders
        self._vals = vals
        self._edges = edges
        self._bucket_words = bucket_words
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
        orders, vals, edges, bucket_words = [], [], [], []
        for j in range(a_num):
            col = num[:, j]
            order = np.argsort(col, kind="stable").astype(np.int64)
            sv = np.ascontiguousarray(col[order])   # column dtype preserved
            b = max(1, min(int(n_buckets), n)) if n else 1
            e = np.round(np.linspace(0, n, b + 1)).astype(np.int64)
            bw = np.zeros((b, n_words(n)), dtype=np.uint32)
            for i in range(b):
                bw[i] = words_from_ids(order[e[i]:e[i + 1]], n)
            orders.append(order)
            vals.append(sv)
            edges.append(e)
            bucket_words.append(bw)
        return RangeIndex(n, orders, vals, edges, bucket_words)

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
        i0 = int(np.searchsorted(e, left, side="left"))    # first edge >= left
        i1 = int(np.searchsorted(e, right, side="right")) - 1  # last edge <= right
        if i0 < i1:
            # full buckets [i0, i1) OR'd in one vectorised reduce; only the
            # boundary slices (each at most one bucket of rows) pack fresh
            w = np.bitwise_or.reduce(self._bucket_words[attr][i0:i1], axis=0)
            partial = np.concatenate([order[left:e[i0]], order[e[i1]:right]])
        else:
            w = empty_words(self.n)
            partial = order[left:right]
        return word_or(w, words_from_ids(partial, self.n))

    def union_words(self, attr: int, intervals: Sequence[Tuple[float, float]]) -> np.ndarray:
        """Bitmap of a union of intervals over one attribute.  ``RangePred``
        construction merges overlaps, so the union is a plain OR."""
        w = empty_words(self.n)
        for lo, hi in intervals:
            w = word_or(w, self.interval_words(attr, lo, hi))
        return w
