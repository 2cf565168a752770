"""repro_torch.filter — attribute indexes and the DNF predicate compiler.

The third leg of the query planner's stool: where pre-filtering scans the
metadata columns per query and post-filtering probes the vector index
first, the *indexed* pre-filter answers the predicate from precomputed
packed-bitset indexes (``bitmap`` for categorical labels, ``ranges`` for
numeric intervals), compiled per predicate (``compile``) and memoised
across serving traffic (``cache``).  Exact popcount selectivities fall out
for free and feed the planner's ``sel_is_exact`` fast path.
"""
from .bitmap import (
    BitmapLabelIndex,
    WORD_BITS,
    empty_words,
    expand_words,
    full_words,
    n_words,
    pack_mask,
    popcount_words,
    words_from_ids,
)
from .ranges import DEFAULT_BUCKETS, RangeIndex
from .compile import AttributeIndex, CompiledPredicate
from .cache import PredicateCache, canonical_key

__all__ = [
    "WORD_BITS",
    "n_words",
    "pack_mask",
    "expand_words",
    "popcount_words",
    "words_from_ids",
    "full_words",
    "empty_words",
    "BitmapLabelIndex",
    "RangeIndex",
    "DEFAULT_BUCKETS",
    "AttributeIndex",
    "CompiledPredicate",
    "PredicateCache",
    "canonical_key",
]
