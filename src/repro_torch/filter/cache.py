"""LRU compiled-predicate cache keyed by canonicalised predicate.

Serving traffic repeats predicates constantly (the same storefront filter,
the same date window), and differently-constructed but logically identical
predicates should share one compilation: ``canonical_key`` normalises
conjunct/term order and duplicates, so
``Predicate(labels=(A, B))`` and ``Predicate(labels=(B, A, A))`` hit the
same cache line.  (``RangePred`` already canonicalises its intervals —
sorted, merged, empties dropped — at construction.)

One cache instance is shared between the selectivity estimator's exact fast
path and the indexed pre-filter executor, so a planned-then-executed query
compiles its bitmap exactly once; the compiled object also caches its bool
mask expansion, making repeat evaluations ~free.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

from ..core.predicates import AnyPredicate, LabelEq, Not, Or, Predicate, RangePred
from ..obs.trace import NULL_TRACER
from .compile import AttributeIndex, CompiledPredicate

__all__ = ["canonical_key", "PredicateCache"]


def canonical_key(pred) -> Tuple:
    """Order- and duplicate-insensitive structural key for any IR node."""
    if isinstance(pred, LabelEq):
        return ("L", int(pred.attr), int(pred.code))
    if isinstance(pred, RangePred):
        return ("R", int(pred.attr), pred.intervals)
    if isinstance(pred, Not):
        return ("N", canonical_key(pred.term))
    if isinstance(pred, Predicate):
        leaves = sorted(
            {canonical_key(p) for p in (*pred.labels, *pred.ranges, *pred.nots)}
        )
        return ("AND", tuple(leaves))
    if isinstance(pred, Or):
        return ("OR", tuple(sorted({canonical_key(t) for t in pred.terms})))
    raise TypeError(f"not a predicate IR node: {type(pred).__name__}")


class PredicateCache:
    """LRU map: canonical predicate key -> :class:`CompiledPredicate`.

    Packed words are cheap (N/8 bytes) and live for the full ``capacity``;
    expanded bool masks are 8x bigger, so only the ``mask_capacity`` most
    recently *executed* predicates keep theirs materialised (:meth:`mask`
    re-expands from the words on a mask-tier miss — O(N/8), still ~30x
    cheaper than a scan).  This bounds worst-case memory at
    ``capacity*N/8 + mask_capacity*N`` bytes instead of ``capacity*9N/8``.
    """

    def __init__(self, capacity: int = 256, mask_capacity: int = 64):
        assert capacity >= 1 and mask_capacity >= 1
        self.capacity = capacity
        self.mask_capacity = mask_capacity
        self._store: "OrderedDict[Tuple, CompiledPredicate]" = OrderedDict()
        self._masks: "OrderedDict[Tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        # mask-tier split (subset of hits/misses above): the obs layer's
        # cache_hit_ratio gauge tracks the expanded-mask tier separately,
        # since a mask-tier miss still costs an O(N/8) re-expansion
        self.mask_hits = 0
        self.mask_misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def get_or_compile(self, pred: AnyPredicate, index: AttributeIndex,
                       tracer=None) -> CompiledPredicate:
        """The cached compilation of ``pred``; a miss compiles it, under a
        ``bitmap_compile`` span of ``tracer`` when one is given, which
        carries ``cut_rows``: the rows its range leaves packed at their
        interval cuts (:class:`~repro_torch.filter.ranges.RangeIndex`)."""
        key = canonical_key(pred)
        hit = self._store.get(key)
        if hit is not None:
            self.hits += 1
            self._store.move_to_end(key)
            return hit
        self.misses += 1
        tr = tracer if tracer is not None else NULL_TRACER
        with tr.span("bitmap_compile"):
            cut0 = index.ranges.cut_rows
            compiled = index.compile(pred)
            tr.annotate(cut_rows=index.ranges.cut_rows - cut0)
        self._store[key] = compiled
        if len(self._store) > self.capacity:
            old_key, _ = self._store.popitem(last=False)
            self._masks.pop(old_key, None)
            self.evictions += 1
        return compiled

    def mask(self, pred: AnyPredicate, index: AttributeIndex):
        """Bool candidate mask for ``pred``, through both cache tiers —
        the executors' entry point."""
        from .bitmap import expand_words

        key = canonical_key(pred)
        m = self._masks.get(key)
        if m is None:
            self.mask_misses += 1
            c = self.get_or_compile(pred, index)
            m = expand_words(c.words, c.n)
            self._masks[key] = m
            if len(self._masks) > self.mask_capacity:
                self._masks.popitem(last=False)
        else:
            self._masks.move_to_end(key)
            self.hits += 1
            self.mask_hits += 1
        return m

    def invalidate(self) -> None:
        """Drop every compiled entry because the CORPUS changed under them
        (live-corpus upsert: stored words have the old row count).  Unlike
        :meth:`clear`, the hit/miss history survives and the invalidation
        is counted — mutation-driven churn must be observable in
        ``stats()`` (engine telemetry asserts on it)."""
        self._store.clear()
        self._masks.clear()
        self.invalidations += 1

    def stats(self) -> Dict[str, int]:
        return {
            "size": len(self._store),
            "capacity": self.capacity,
            "masks": len(self._masks),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "mask_hits": self.mask_hits,
            "mask_misses": self.mask_misses,
        }

    def clear(self) -> None:
        self._store.clear()
        self._masks.clear()
        self.hits = self.misses = self.evictions = 0
        self.mask_hits = self.mask_misses = 0
