"""Packed bitset primitives + per-label bitmap indexes.

A bitmap is a ``(ceil(N/32),)`` uint32 array; bit ``i`` of the corpus lives
at word ``i >> 5``, position ``i & 31`` (little-endian byte order within the
word, matching ``np.packbits(bitorder="little")`` viewed as uint32 on LE
hosts — the only hosts this repo targets).  All bitmaps maintain the
invariant that tail bits beyond ``n`` are zero, so popcounts and word-wise
combines never need an extra mask except after complement (``word_andnot``
re-clears the tail).

Why words and not bool masks: predicate evaluation over packed words touches
N/32 uint32s per leaf instead of N floats/ints per leaf — the 32x word
parallelism (plus cache locality) is where the indexed pre-filter's speedup
over scan-mask evaluation comes from.  Expansion back to a bool mask
(``expand_words``) is the bridge to the mask-native kernels
(``kernels.ops.fused_masked_topk``).
"""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = [
    "WORD_BITS",
    "n_words",
    "pack_mask",
    "expand_words",
    "popcount_words",
    "words_from_ids",
    "full_words",
    "empty_words",
    "word_and",
    "word_or",
    "word_andnot",
    "clear_tail",
    "BitmapLabelIndex",
]

WORD_BITS = 32


def n_words(n: int) -> int:
    return (int(n) + WORD_BITS - 1) // WORD_BITS


def clear_tail(words: np.ndarray, n: int) -> np.ndarray:
    """Zero the bits beyond ``n`` in the last word (in place); returns words."""
    rem = n & (WORD_BITS - 1)
    if words.size and rem:
        words[-1] &= np.uint32((1 << rem) - 1)
    return words


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """Bool mask (N,) -> packed uint32 words (tail bits zero)."""
    mask = np.asarray(mask, dtype=bool)
    nw = n_words(mask.size)
    by = np.packbits(mask, bitorder="little")
    if by.size < 4 * nw:
        by = np.pad(by, (0, 4 * nw - by.size))
    return by.view(np.uint32).copy()


def expand_words(words: np.ndarray, n: int) -> np.ndarray:
    """Packed words -> bool mask of length ``n``."""
    if n == 0:
        return np.zeros(0, dtype=bool)
    bits = np.unpackbits(words.view(np.uint8), count=n, bitorder="little")
    return bits.astype(bool)


if hasattr(np, "bitwise_count"):

    def popcount_words(words: np.ndarray) -> int:
        """Number of set bits (numpy >= 2: hardware popcount)."""
        return int(np.bitwise_count(words).sum())

else:  # numpy < 2 fallback: byte-wise lookup table
    _POPCNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint16)

    def popcount_words(words: np.ndarray) -> int:
        """Number of set bits (LUT over the uint8 view)."""
        return int(_POPCNT8[words.view(np.uint8)].sum())


def words_from_ids(ids: np.ndarray, n: int) -> np.ndarray:
    """Packed bitmap with exactly the bits in ``ids`` (int row ids) set."""
    words = np.zeros(n_words(n), dtype=np.uint32)
    if ids.size:
        ids = np.asarray(ids, dtype=np.int64)
        np.bitwise_or.at(words, ids >> 5, np.uint32(1) << (ids & 31).astype(np.uint32))
    return words


def full_words(n: int) -> np.ndarray:
    words = np.full(n_words(n), np.uint32(0xFFFFFFFF), dtype=np.uint32)
    return clear_tail(words, n)


def empty_words(n: int) -> np.ndarray:
    return np.zeros(n_words(n), dtype=np.uint32)


def word_and(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a & b


def word_or(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a | b


def word_andnot(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """``a AND NOT b`` — the complement re-sets tail bits, so re-clear them."""
    return clear_tail(a & ~b, n)


# An attribute with more distinct codes than this is not bitmap-indexed
# (dense per-code bitmaps over an ID-like column would cost O(codes * N/8)
# bytes); the compiler reports it uncovered and executors fall back to the
# columnar scan for predicates touching it.
MAX_CODES_INDEXED = 4096


class BitmapLabelIndex:
    """Per-categorical-attribute, per-*present*-code packed bitmaps.

    ``bitmap(attr, code)`` answers ``cat[:, attr] == code`` in O(1) (a dict
    lookup), including ``code == NULL_CODE`` (missing-attribute rows get
    their own bitmap so negations and explicit NULL queries stay exact).
    Codes absent from the column return the empty bitmap — exactly what the
    columnar scan would produce.  Build is one argsort + one
    ``words_from_ids`` pass per attribute (O(N log N), independent of the
    code-space size — a sparse column with max code 10^6 costs the same as
    a dense one); attributes with more than :data:`MAX_CODES_INDEXED`
    distinct codes are left unindexed (see :meth:`indexed`).
    """

    def __init__(self, n: int, code_words: List[dict], indexed: List[bool]):
        self.n = n
        self._code_words = code_words      # per attr: {code: words}
        self._indexed = indexed

    @property
    def n_attrs(self) -> int:
        return len(self._code_words)

    def indexed(self, attr: int) -> bool:
        return self._indexed[attr]

    @staticmethod
    def build(cat: np.ndarray) -> "BitmapLabelIndex":
        cat = np.asarray(cat)
        n = cat.shape[0] if cat.ndim >= 2 else 0
        a_cat = cat.shape[1] if cat.ndim >= 2 else 0
        code_words: List[dict] = []
        indexed: List[bool] = []
        for a in range(a_cat):
            col = cat[:, a]
            order = np.argsort(col, kind="stable").astype(np.int64)
            sc = col[order]
            codes, starts = (np.unique(sc, return_index=True) if n
                             else (np.empty(0, col.dtype), np.empty(0, np.int64)))
            if codes.size > MAX_CODES_INDEXED:
                code_words.append({})
                indexed.append(False)
                continue
            bounds = np.append(starts, n)
            code_words.append({
                int(c): words_from_ids(order[starts[j]:bounds[j + 1]], n)
                for j, c in enumerate(codes)
            })
            indexed.append(True)
        return BitmapLabelIndex(n, code_words, indexed)

    def bitmap(self, attr: int, code: int) -> np.ndarray:
        w = self._code_words[attr].get(int(code))
        return w if w is not None else empty_words(self.n)

    # ------------------------------------------------------------------
    def extend(self, cat_new: np.ndarray) -> "BitmapLabelIndex":
        """Incrementally index appended rows (the live-corpus upsert path).

        Existing per-code bitmaps are zero-padded to the grown word count
        (appended rows don't carry old codes' bits), then the new rows'
        bits OR in per distinct code — O(codes · N/32 + rows) per batch,
        no rebuild.  An attribute whose distinct-code count crosses
        :data:`MAX_CODES_INDEXED` drops to unindexed (fail closed, same as
        at build time).  Deletes never come through here: tombstones are
        ANDNOT-composed at query time, so stored bitmaps stay exact.
        """
        cat_new = np.atleast_2d(np.asarray(cat_new))
        rows = cat_new.shape[0]
        if rows == 0:
            return self
        old_n, new_n = self.n, self.n + rows
        nw = n_words(new_n)
        for a in range(self.n_attrs):
            if not self._indexed[a]:
                continue
            d = self._code_words[a]
            for code in d:
                d[code] = (np.pad(d[code], (0, nw - d[code].size))
                           if d[code].size < nw else d[code])
            col = cat_new[:, a]
            for code in np.unique(col):
                ids = old_n + np.nonzero(col == code)[0]
                add = words_from_ids(ids, new_n)
                prev = d.get(int(code))
                d[int(code)] = add if prev is None else word_or(prev, add)
            if len(d) > MAX_CODES_INDEXED:
                self._code_words[a] = {}
                self._indexed[a] = False
        self.n = new_n
        return self
