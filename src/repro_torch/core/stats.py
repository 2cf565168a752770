"""Dataset statistics backing the selectivity estimator (paper §3.2).

Precomputed at index-build time:

* per-label frequency dictionary          (exact, full dataset)
* 2-D label co-occurrence matrix          (exact, full dataset)
* per-numeric-attribute histograms        (1,024 equi-width bins, full dataset)
* label-range co-occurrence               (per-label conditional histograms,
                                           computed on the 1-5 % sample)
* PMI between label pairs                 (derived from the matrices above)

Labels live in a flattened *global id* space: categorical attribute ``a``
with cardinality ``C_a`` owns ids ``[offset_a, offset_a + C_a)``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .predicates import Predicate, RangePred, label_ids

__all__ = ["DatasetStats", "HIST_BINS"]

# Paper §3.2.2: "using 1,024 histogram bins accurately captures the
# distribution of range predicates".
HIST_BINS = 1024
# Conditional (label-range) histograms are built on the sample; coarser bins.
COND_HIST_BINS = 64


@dataclasses.dataclass
class Histogram:
    """Equi-width histogram with fractional boundary-bin interpolation."""

    lo: float
    hi: float
    counts: np.ndarray  # (bins,), float64
    total: float        # number of points histogrammed

    @property
    def bins(self) -> int:
        return int(self.counts.shape[0])

    @property
    def width(self) -> float:
        return (self.hi - self.lo) / self.bins

    def range_mass(self, lo: float, hi: float) -> float:
        """Estimated COUNT of points in [lo, hi): sums fully covered bins and
        takes the covered fraction of partially overlapped boundary bins
        (uniform-within-bin assumption, paper §3.2.2)."""
        lo = max(lo, self.lo)
        hi = min(hi, self.hi)
        if hi <= lo or self.total == 0 or self.width <= 0:
            return 0.0
        # Continuous bin coordinates of the query range.
        a = (lo - self.lo) / self.width
        b = (hi - self.lo) / self.width
        ia, ib = int(np.floor(a)), int(np.ceil(b))
        ia = max(ia, 0)
        ib = min(ib, self.bins)
        mass = 0.0
        for i in range(ia, ib):
            # Overlap of [a, b) with bin [i, i+1), as a fraction of the bin.
            frac = min(b, i + 1.0) - max(a, float(i))
            if frac > 0:
                mass += float(self.counts[i]) * min(frac, 1.0)
        return mass

    def selectivity(self, intervals: Sequence[Tuple[float, float]]) -> float:
        """Selectivity of a union of disjoint intervals over this attribute."""
        if self.total == 0:
            return 0.0
        return float(sum(self.range_mass(lo, hi) for lo, hi in intervals) / self.total)

    @staticmethod
    def build(x: np.ndarray, bins: int = HIST_BINS) -> "Histogram":
        x = np.asarray(x, dtype=np.float64)
        lo, hi = float(x.min()), float(x.max())
        if hi <= lo:
            hi = lo + 1.0
        counts, _ = np.histogram(x, bins=bins, range=(lo, hi))
        return Histogram(lo=lo, hi=hi, counts=counts.astype(np.float64), total=float(x.size))


@dataclasses.dataclass
class DatasetStats:
    """All precomputed statistics for one dataset."""

    n: int                       # corpus size
    dim: int                     # vector dimensionality
    cat_cards: Tuple[int, ...]   # cardinality per categorical attribute
    cat_offsets: Tuple[int, ...] # global-label-id offsets per attribute
    n_labels: int                # total labels across attributes

    label_freq: np.ndarray       # (n_labels,) exact frequency (fraction of N)
    cooc: np.ndarray             # (n_labels, n_labels) joint frequency (fraction)
    hists: List[Histogram]       # per numeric attribute, full dataset
    # label-range co-occurrence: cond_hists[lbl][num_attr] -> Histogram of that
    # numeric attribute over sample points carrying label ``lbl``.
    cond_hists: List[List[Optional[Histogram]]]
    sample_idx: np.ndarray       # indices of the 1-5 % sample
    dist_measure: float          # vector-distribution feature for the planner
    sample_frac: float

    # ------------------------------------------------------------------
    @staticmethod
    def build(
        vectors: np.ndarray,
        cat: np.ndarray,
        num: np.ndarray,
        sample_frac: float = 0.02,
        seed: int = 0,
    ) -> "DatasetStats":
        """Build all statistics.  ``sample_frac`` follows the paper's 1-5 %
        sampling for multi-label interaction statistics."""
        rng = np.random.default_rng(seed)
        n = vectors.shape[0]
        a_cat = cat.shape[1] if cat.size else 0
        a_num = num.shape[1] if num.size else 0

        cards = tuple(int(cat[:, a].max()) + 1 if n else 0 for a in range(a_cat))
        offsets, off = [], 0
        for c in cards:
            offsets.append(off)
            off += c
        n_labels = off

        # --- exact label frequencies (full dataset) -------------------
        freq = np.zeros(n_labels, dtype=np.float64)
        onehot_cols = []
        for a in range(a_cat):
            codes = cat[:, a]
            valid = codes >= 0
            bc = np.bincount(codes[valid], minlength=cards[a]).astype(np.float64)
            freq[offsets[a] : offsets[a] + cards[a]] = bc / n
            onehot_cols.append((codes, valid, a))

        # --- 2-D co-occurrence matrix (full dataset, exact) -----------
        # Built as G^T G / n with G the (n, n_labels) one-hot indicator.
        # For our label-space sizes (<= few thousand) this is cheap.
        cooc = np.zeros((n_labels, n_labels), dtype=np.float64)
        if n_labels:
            g = np.zeros((n, n_labels), dtype=np.float32)
            for a in range(a_cat):
                codes = cat[:, a]
                valid = codes >= 0
                g[np.nonzero(valid)[0], offsets[a] + codes[valid]] = 1.0
            cooc = (g.T @ g).astype(np.float64) / n

        # --- numeric histograms (full dataset) ------------------------
        hists = [Histogram.build(num[:, j], HIST_BINS) for j in range(a_num)]

        # --- 1-5 % sample + label-range conditional histograms --------
        n_sample = max(1, int(round(sample_frac * n)))
        sample_idx = rng.choice(n, size=n_sample, replace=False)
        cond: List[List[Optional[Histogram]]] = [[None] * a_num for _ in range(n_labels)]
        if n_labels and a_num:
            s_cat, s_num = cat[sample_idx], num[sample_idx]
            for a in range(a_cat):
                codes = s_cat[:, a]
                for code in range(cards[a]):
                    rows = codes == code
                    if rows.sum() < 4:  # too few sample points to histogram
                        continue
                    lbl = offsets[a] + code
                    for j in range(a_num):
                        h = Histogram.build(s_num[rows, j], COND_HIST_BINS)
                        # rescale "total" so range_mass/selectivity stays the
                        # conditional P(range | label); but keep joint scale
                        # available through label_range_joint() below.
                        cond[lbl][j] = h

        # --- vector distribution measure -------------------------------
        # Mean pairwise distance over a small sample, normalised by sqrt(dim):
        # a scale-free "spread" feature for the planner (paper: "vector
        # distribution measure").
        m = min(1024, n)
        sub = vectors[rng.choice(n, size=m, replace=False)].astype(np.float64)
        centred = sub - sub.mean(0)
        dist_measure = float(np.sqrt((centred**2).sum(1).mean()) / np.sqrt(vectors.shape[1]))

        return DatasetStats(
            n=n,
            dim=int(vectors.shape[1]),
            cat_cards=cards,
            cat_offsets=tuple(offsets),
            n_labels=n_labels,
            label_freq=freq,
            cooc=cooc,
            hists=hists,
            cond_hists=cond,
            sample_idx=sample_idx,
            dist_measure=dist_measure,
            sample_frac=float(sample_frac),
        )

    # ------------------------------------------------------------------
    # live-corpus incremental refresh
    # ------------------------------------------------------------------
    def apply_delta(
        self,
        added_cat: Optional[np.ndarray] = None,
        added_num: Optional[np.ndarray] = None,
        removed_cat: Optional[np.ndarray] = None,
        removed_num: Optional[np.ndarray] = None,
    ) -> "DatasetStats":
        """Fold a mutation batch into the full-dataset statistics without a
        rebuild: counts behind ``label_freq``/``cooc``/``hists`` add the
        appended rows and subtract the tombstoned rows, then renormalise
        over the new live count.

        Approximation boundaries (these are planner *estimates*; exactness
        stays the attribute index's job): codes outside the build-time
        cardinality can't be represented in the flattened label space and
        are dropped until a compaction rebuild widens it; histogram bin
        edges are frozen, so values outside the build-time ``[lo, hi)``
        adjust ``total`` but no bin; the sample-based conditional
        histograms are left as built.
        """
        a_cat = len(self.cat_cards)
        a_num = len(self.hists)

        def _counts_delta(rows_cat, sign):
            if rows_cat is None or rows_cat.shape[0] == 0:
                return 0
            rows_cat = np.atleast_2d(rows_cat)
            g = np.zeros((rows_cat.shape[0], self.n_labels), np.float32)
            for a in range(a_cat):
                codes = rows_cat[:, a]
                ok = (codes >= 0) & (codes < self.cat_cards[a])
                bc = np.bincount(codes[ok], minlength=self.cat_cards[a])
                lo = self.cat_offsets[a]
                self._label_counts[lo:lo + self.cat_cards[a]] += sign * bc
                g[np.nonzero(ok)[0], lo + codes[ok]] = 1.0
            if self.n_labels:
                self._cooc_counts += sign * (g.T @ g).astype(np.float64)
            return rows_cat.shape[0]

        def _hist_delta(rows_num, sign):
            if rows_num is None or rows_num.shape[0] == 0:
                return
            rows_num = np.atleast_2d(rows_num)
            for j in range(a_num):
                h = self.hists[j]
                c, _ = np.histogram(rows_num[:, j], bins=h.bins,
                                    range=(h.lo, h.hi))
                h.counts += sign * c
                np.maximum(h.counts, 0.0, out=h.counts)
                h.total = max(h.total + sign * rows_num.shape[0], 0.0)

        if not hasattr(self, "_label_counts"):
            self._label_counts = self.label_freq * self.n
            self._cooc_counts = self.cooc * self.n
        n_add = _counts_delta(added_cat, +1)
        n_rem = _counts_delta(removed_cat, -1)
        _hist_delta(added_num, +1)
        _hist_delta(removed_num, -1)
        self.n = max(self.n + n_add - n_rem, 0)
        np.maximum(self._label_counts, 0.0, out=self._label_counts)
        np.maximum(self._cooc_counts, 0.0, out=self._cooc_counts)
        denom = max(self.n, 1)
        self.label_freq = self._label_counts / denom
        self.cooc = self._cooc_counts / denom
        return self

    # ------------------------------------------------------------------
    # lookups used by the estimator
    # ------------------------------------------------------------------
    def single_label_sel(self, lbl: int) -> float:
        return float(self.label_freq[lbl])

    def pair_joint_sel(self, l1: int, l2: int) -> float:
        return float(self.cooc[l1, l2])

    def pmi(self, l1: int, l2: int, eps: float = 1e-12) -> float:
        """Pointwise mutual information between two labels (paper §3.2.1)."""
        pxy = self.cooc[l1, l2]
        px, py = self.label_freq[l1], self.label_freq[l2]
        return float(np.log((pxy + eps) / (px * py + eps)))

    def range_sel(self, r: RangePred) -> float:
        return self.hists[r.attr].selectivity(r.intervals)

    def label_range_joint(self, lbl: int, r: RangePred) -> float:
        """Joint selectivity P(label AND range) from the label-range
        co-occurrence statistics (conditional hist x label marginal)."""
        h = self.cond_hists[lbl][r.attr] if self.n_labels else None
        if h is None:
            # fall back to independence
            return self.single_label_sel(lbl) * self.range_sel(r)
        return h.selectivity(r.intervals) * self.single_label_sel(lbl)

    def independence_sel(self, pred: Predicate) -> float:
        """Selectivity assuming all conjuncts independent (negated leaves
        contribute their complement's marginal)."""
        s = 1.0
        for lbl in label_ids(pred, self.cat_offsets):
            s *= self.single_label_sel(lbl)
        for r in pred.ranges:
            s *= self.range_sel(r)
        for nt in pred.nots:
            if isinstance(nt.term, RangePred):
                s *= 1.0 - self.range_sel(nt.term)
            elif (0 <= nt.term.attr < len(self.cat_cards)
                  and 0 <= nt.term.code < self.cat_cards[nt.term.attr]):
                s *= 1.0 - self.single_label_sel(self.cat_offsets[nt.term.attr] + nt.term.code)
            # else: the label matches nothing, so its negation has
            # selectivity 1 — no factor
        return s
