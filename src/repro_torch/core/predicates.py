"""Predicate IR for filtered ANN queries.

A filtered ANN query is ``(Q, P, k)`` (paper §3).  ``P`` is a predicate over
the metadata record attached to each vector.  The paper supports:

* single-label equality            ``color = green``
* conjunctions of labels           ``color = green AND type = shoes``
* numeric range                    ``age > 20 AND age < 25``
* unions of ranges on ONE attr     ``(20 < age < 25) OR age < 10``
* mixed label + range              ``color = green AND price < 30``

Beyond the paper, the IR is closed under disjunction and leaf negation in
**disjunctive normal form**: :class:`Or` is a union of conjunctions
(:class:`Predicate`), and each conjunction may carry negated leaves
(:class:`Not` over a ``LabelEq``/``RangePred``).  The original conjunctive
:class:`Predicate` is the degenerate one-term DNF and remains valid
everywhere unchanged.  ``repro_torch.filter`` compiles any of these shapes to a
packed bitmap with exact popcount selectivity.

Metadata layout (columnar, fixed dtypes so everything vectorises):

* categorical attributes -> int32 codes, array ``cat``  of shape (N, A_cat)
* numeric attributes     -> float32,     array ``num``  of shape (N, A_num)

Evaluation returns a boolean mask of shape (N,).  Masks — not compacted
index lists — are the TPU-native filtered-search currency (DESIGN.md §2);
the numpy path additionally offers ``nonzero`` compaction for the CPU
pre-filter executor.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "LabelEq",
    "RangePred",
    "Not",
    "Predicate",
    "Or",
    "AnyPredicate",
    "iter_leaves",
    "label_ids",
    "NULL_CODE",
]

# Code used for "attribute missing" in categorical columns.
NULL_CODE = -1


def _n_rows(cat: np.ndarray, num: np.ndarray) -> int:
    """Corpus row count from the metadata arrays, robust to degenerate
    shapes: zero-attribute corpora arrive as (N, 0) — whose ``size`` is 0
    even though N > 0 — and no-attribute corpora may arrive as empty 1-D
    arrays.  Prefer the first 2-D operand's leading dim."""
    if cat.ndim >= 2:
        return cat.shape[0]
    if num.ndim >= 2:
        return num.shape[0]
    return max(
        cat.shape[0] if cat.ndim == 1 else 0,
        num.shape[0] if num.ndim == 1 else 0,
    )


@dataclasses.dataclass(frozen=True)
class LabelEq:
    """``attr == code`` over a categorical attribute."""

    attr: int  # categorical attribute index
    code: int  # value code within that attribute's dictionary

    def eval(self, cat: np.ndarray, num: np.ndarray) -> np.ndarray:
        return cat[:, self.attr] == self.code


@dataclasses.dataclass(frozen=True)
class RangePred:
    """Union of half-open intervals ``lo <= x < hi`` over ONE numeric attribute.

    ``intervals`` is a tuple of (lo, hi) pairs; the union is the full query
    range (paper §3.2.2: multi-range predicates are unions over the same
    attribute).  A single interval is the common case.  Construction
    canonicalises: empty intervals (hi <= lo) are dropped and
    overlapping/adjacent intervals merge, so ``total_width`` (a planner and
    selectivity feature) measures the true covered width — e.g.
    ``((0, 10), (5, 15))`` is stored as ``((0, 15),)`` with width 15, not 20.
    """

    attr: int  # numeric attribute index
    intervals: Tuple[Tuple[float, float], ...]

    def __post_init__(self):
        ivs = sorted(
            (float(lo), float(hi)) for lo, hi in self.intervals if float(hi) > float(lo)
        )
        merged: List[Tuple[float, float]] = []
        for lo, hi in ivs:
            if merged and lo <= merged[-1][1]:  # overlap or adjacency: one span
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        object.__setattr__(self, "intervals", tuple(merged))

    @property
    def total_width(self) -> float:
        return float(sum(hi - lo for lo, hi in self.intervals))

    @property
    def midpoint(self) -> float:
        if not self.intervals:
            return 0.0
        los = min(lo for lo, _ in self.intervals)
        his = max(hi for _, hi in self.intervals)
        return 0.5 * (los + his)

    def eval(self, cat: np.ndarray, num: np.ndarray) -> np.ndarray:
        x = num[:, self.attr]
        m = np.zeros(x.shape[0], dtype=bool)
        for lo, hi in self.intervals:
            m |= (x >= lo) & (x < hi)
        return m


@dataclasses.dataclass(frozen=True)
class Not:
    """Negated leaf: ``NOT (attr == code)`` or ``NOT (x in ranges)``.

    Negation is restricted to leaves — combined with :class:`Predicate`
    (AND) and :class:`Or` (union of ANDs) this is exactly DNF, which is the
    class the bitmap compiler handles with one ANDNOT per negated leaf.
    """

    term: Union[LabelEq, RangePred]

    def eval(self, cat: np.ndarray, num: np.ndarray) -> np.ndarray:
        return ~self.term.eval(cat, num)


@dataclasses.dataclass(frozen=True)
class Predicate:
    """Conjunction of label predicates, range predicates and negated leaves
    (the paper's predicate class, extended with leaf negation).  ``labels``
    AND ``ranges`` AND ``nots`` must all hold."""

    labels: Tuple[LabelEq, ...] = ()
    ranges: Tuple[RangePred, ...] = ()
    nots: Tuple[Not, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "labels", tuple(self.labels))
        object.__setattr__(self, "ranges", tuple(self.ranges))
        object.__setattr__(self, "nots", tuple(self.nots))

    # ---- classification used by the selectivity-estimator router ----
    @property
    def n_labels(self) -> int:
        return len(self.labels) + sum(
            1 for p in self.nots if isinstance(p.term, LabelEq)
        )

    @property
    def n_ranges(self) -> int:
        return len(self.ranges) + sum(
            1 for p in self.nots if isinstance(p.term, RangePred)
        )

    @property
    def kind(self) -> str:
        if self.n_ranges == 0:
            return "label"
        if self.n_labels == 0:
            return "range"
        return "mixed"

    # ---- evaluation -------------------------------------------------
    def eval(self, cat: np.ndarray, num: np.ndarray) -> np.ndarray:
        m = np.ones(_n_rows(cat, num), dtype=bool)
        for p in self.labels:
            m &= p.eval(cat, num)
        for p in self.ranges:
            m &= p.eval(cat, num)
        for p in self.nots:
            m &= p.eval(cat, num)
        return m

    def selectivity(self, cat: np.ndarray, num: np.ndarray) -> float:
        """Ground-truth selectivity (fraction of points passing); 0.0 on an
        empty corpus (no points, so no passing fraction to speak of)."""
        m = self.eval(cat, num)
        return float(m.mean()) if m.size else 0.0

    def __str__(self) -> str:  # debugging sugar
        parts = [f"c{p.attr}={p.code}" for p in self.labels]
        for r in self.ranges:
            parts.append(
                "n%d in %s" % (r.attr, "|".join(f"[{lo:.3g},{hi:.3g})" for lo, hi in r.intervals))
            )
        for p in self.nots:
            t = p.term
            if isinstance(t, LabelEq):
                parts.append(f"NOT c{t.attr}={t.code}")
            else:
                parts.append(
                    "NOT n%d in %s"
                    % (t.attr, "|".join(f"[{lo:.3g},{hi:.3g})" for lo, hi in t.intervals))
                )
        return " AND ".join(parts) if parts else "TRUE"


def _coerce_term(t) -> Predicate:
    if isinstance(t, Predicate):
        return t
    if isinstance(t, LabelEq):
        return Predicate(labels=(t,))
    if isinstance(t, RangePred):
        return Predicate(ranges=(t,))
    if isinstance(t, Not):
        return Predicate(nots=(t,))
    raise TypeError(f"Or term must be a Predicate or leaf, got {type(t).__name__}")


@dataclasses.dataclass(frozen=True)
class Or:
    """Disjunction of conjunctions — DNF over ``LabelEq``/``RangePred``
    leaves.  Bare leaves coerce to single-leaf conjunctions, so
    ``Or((LabelEq(0, 1), pred))`` reads naturally.  ``Or(())`` is FALSE."""

    terms: Tuple[Predicate, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "terms", tuple(_coerce_term(t) for t in self.terms))

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def kind(self) -> str:
        kinds = {t.kind for t in self.terms}
        return kinds.pop() if len(kinds) == 1 else "mixed"

    def eval(self, cat: np.ndarray, num: np.ndarray) -> np.ndarray:
        m = np.zeros(_n_rows(cat, num), dtype=bool)
        for t in self.terms:
            m |= t.eval(cat, num)
        return m

    def selectivity(self, cat: np.ndarray, num: np.ndarray) -> float:
        m = self.eval(cat, num)
        return float(m.mean()) if m.size else 0.0

    def __str__(self) -> str:
        return " OR ".join(f"({t})" for t in self.terms) if self.terms else "FALSE"


# Anything the engine/executors accept as "a predicate".
AnyPredicate = Union[Predicate, Or]


def iter_leaves(pred: AnyPredicate) -> Iterator[Union[LabelEq, RangePred]]:
    """Every leaf in the DNF, negated or not (coverage checks, compilers)."""
    terms = pred.terms if isinstance(pred, Or) else (pred,)
    for t in terms:
        yield from t.labels
        yield from t.ranges
        for n in t.nots:
            yield n.term


def label_ids(pred: Predicate, cat_offsets: Sequence[int]) -> List[int]:
    """Map each (positive) LabelEq to a *global* label id:
    ``offset[attr] + code``.

    Global label ids index the flattened label space used by the frequency
    dictionary / co-occurrence matrix in :mod:`repro_torch.core.stats`.
    """
    return [cat_offsets[p.attr] + p.code for p in pred.labels]
