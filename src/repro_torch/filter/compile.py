"""DNF predicate -> packed-bitmap compiler with exact popcount selectivity.

``AttributeIndex`` bundles the per-label bitmap index (categorical
attributes) and the sorted-order/equi-depth range index (numeric
attributes) built once at corpus build/shard time.  ``compile()`` walks any
:class:`repro_torch.core.predicates.AnyPredicate` in DNF:

* ``LabelEq``   -> stored per-code bitmap (AND into the conjunction),
* ``RangePred`` -> OR of searchsorted interval bitmaps (AND in),
* ``Not(leaf)`` -> ANDNOT of the leaf's bitmap,
* ``Predicate`` -> AND over its leaves (empty conjunction = all-ones: TRUE),
* ``Or``        -> OR over its compiled terms (no terms = all-zeros: FALSE).

The result carries the exact match count (``popcount``) — which is also the
exact selectivity the estimator's fast path serves — and expands lazily to
the bool mask the executors and kernels consume.  In serving, executors go
through ``PredicateCache.mask`` (a bounded second cache tier) rather than
:meth:`CompiledPredicate.mask`, so repeat predicates skip the expansion too
without pinning one mask per cached compilation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.predicates import AnyPredicate, LabelEq, Or, Predicate, RangePred, iter_leaves
from .bitmap import (
    BitmapLabelIndex,
    empty_words,
    expand_words,
    full_words,
    popcount_words,
    word_and,
    word_andnot,
    word_or,
)
from .ranges import DEFAULT_BUCKETS, RangeIndex

__all__ = ["CompiledPredicate", "AttributeIndex"]


@dataclasses.dataclass
class CompiledPredicate:
    """A predicate lowered to one packed bitmap over the corpus."""

    words: np.ndarray          # (ceil(n/32),) uint32, tail bits clear
    n: int                     # corpus rows
    popcount: int              # exact number of matching rows
    covered: bool              # True: the bitmap is exact (index covered all leaves)
    _mask: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    @property
    def selectivity(self) -> float:
        return self.popcount / self.n if self.n else 0.0

    def mask(self) -> np.ndarray:
        """Bool mask expansion, cached — a cache-hit predicate pays neither
        compilation nor expansion."""
        if self._mask is None:
            self._mask = expand_words(self.words, self.n)
        return self._mask


class AttributeIndex:
    """Bitmap + range indexes over one corpus's metadata columns."""

    def __init__(self, labels: BitmapLabelIndex, ranges: RangeIndex, n: int):
        self.labels = labels
        self.ranges = ranges
        self.n = n

    @staticmethod
    def build(cat: np.ndarray, num: np.ndarray,
              range_buckets: int = DEFAULT_BUCKETS) -> "AttributeIndex":
        labels = BitmapLabelIndex.build(cat)
        ranges = RangeIndex.build(num, n_buckets=range_buckets)
        return AttributeIndex(labels, ranges, max(labels.n, ranges.n))

    def extend(self, cat_new: np.ndarray, num_new: np.ndarray) -> "AttributeIndex":
        """Live-corpus refresh for appended rows: label bitmaps extend
        incrementally (stay covered and exact over the grown corpus); the
        equi-depth range index cannot, so its attributes go stale and drop
        out of :meth:`covers` until compaction rebuilds them.  The caller
        owns invalidating any compiled-predicate cache — stored bitmaps
        compiled before the extend have the old word count."""
        cat_new = np.atleast_2d(np.asarray(cat_new))
        rows = cat_new.shape[0]
        if rows == 0:
            return self
        self.labels.extend(cat_new)
        if self.ranges.n_attrs:
            self.ranges.mark_stale()
        self.n += rows
        return self

    # ------------------------------------------------------------------
    def _leaf_covered(self, leaf) -> bool:
        if isinstance(leaf, LabelEq):
            return 0 <= leaf.attr < self.labels.n_attrs and self.labels.indexed(leaf.attr)
        if isinstance(leaf, RangePred):
            # a stale (post-mutation) range attribute fails closed: the
            # predicate demotes to the scan path + estimated selectivity
            return (0 <= leaf.attr < self.ranges.n_attrs
                    and self.ranges.fresh(leaf.attr))
        return False

    def covers(self, pred: AnyPredicate) -> bool:
        """True when every leaf references an indexed attribute — i.e. the
        compiled bitmap (and its popcount selectivity) is exact."""
        return all(self._leaf_covered(leaf) for leaf in iter_leaves(pred))

    # ------------------------------------------------------------------
    def _leaf_words(self, leaf) -> np.ndarray:
        if isinstance(leaf, LabelEq):
            return self.labels.bitmap(leaf.attr, leaf.code)
        return self.ranges.union_words(leaf.attr, leaf.intervals)

    def _conj_words(self, pred: Predicate) -> np.ndarray:
        w = full_words(self.n)
        for leaf in (*pred.labels, *pred.ranges):
            w = word_and(w, self._leaf_words(leaf))
        for nt in pred.nots:
            w = word_andnot(w, self._leaf_words(nt.term), self.n)
        return w

    def compile(self, pred: AnyPredicate) -> CompiledPredicate:
        """Lower a DNF predicate to its bitmap.  Raises on uncovered leaves —
        callers gate on :meth:`covers` (the executor falls back to the
        columnar scan for uncovered predicates)."""
        if not self.covers(pred):
            raise ValueError(f"predicate references unindexed attributes: {pred}")
        if isinstance(pred, Or):
            w = empty_words(self.n)
            for t in pred.terms:
                w = word_or(w, self._conj_words(t))
        else:
            w = self._conj_words(pred)
        return CompiledPredicate(
            words=w, n=self.n, popcount=popcount_words(w), covered=True
        )
