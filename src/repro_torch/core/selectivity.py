"""Selectivity estimation (paper §3.2, plus the exact index fast path).

Routing:

* index-covered predicate        -> EXACT popcount selectivity from the
                                    compiled bitmap (repro_torch.filter); no model,
                                    no histogram — the estimate IS the truth,
                                    and the planner features record it as
                                    ``sel_is_exact``.
* pure range predicate           -> histogram estimate only (no model)
* single label                   -> exact frequency-dictionary lookup
* two-label conjunction          -> exact 2-D co-occurrence lookup
* >=3 labels, or mixed label+range -> GBM over lightweight features, with
  range features short-circuited to zero for label-only predicates.
* DNF (``Or``)                   -> per-clause estimates for every
  conjunctive disjunct (each routed through the rules above), plus a
  whole-predicate value: the exact popcount when the index covers the
  DNF, else the independence union ``1 - prod(1 - s_t)``.
* negated leaves without an index -> positive-part estimate scaled by
  ``prod(1 - s_leaf)`` under independence.

The public surface is one pair of methods — :meth:`estimate` and
:meth:`estimate_batch` — returning :class:`SelEstimate` records carrying
the estimate, the exactness flag, and (for ``Or``) the per-clause
breakdown the per-disjunct planner consumes.  The historical
``estimate_ex`` / ``estimate_batch_ex`` tuple spellings survive as thin
deprecated aliases for one release.

Feature vector fed to the GBM (paper §3.2.1 + §3.2.3):
  0: independence-assumption selectivity           (product of marginals)
  1: mean pairwise joint selectivity of label pairs
  2: min  pairwise joint selectivity of label pairs (an upper bound on truth)
  3: mean PMI over label pairs
  4: number of labels
  5: histogram selectivity of the range predicates (product over attrs)
  6: total width of range spans (normalised per attribute domain)
  7: midpoint of range spans (normalised)
  8: sum of label-range pairwise joint selectivities
"""
from __future__ import annotations

import dataclasses
from itertools import combinations
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..obs.trace import NULL_TRACER
from .gbm import GradientBoostingRegressor
from .predicates import LabelEq, Or, Predicate, label_ids
from .stats import DatasetStats

__all__ = ["SelEstimate", "SelectivityEstimator", "N_FEATURES"]

N_FEATURES = 9


@dataclasses.dataclass(frozen=True)
class SelEstimate:
    """One selectivity estimate.

    ``sel``        — estimated (or exact) fraction of corpus rows matching.
    ``is_exact``   — True only on the index-covered popcount path, where the
                     value is ground truth rather than an estimate.
    ``per_clause`` — for ``Or`` predicates, one :class:`SelEstimate` per term
                     (aligned with ``pred.terms``, duplicates included); None
                     for conjunctions.
    """

    sel: float
    is_exact: bool = False
    per_clause: Optional[Tuple["SelEstimate", ...]] = None

    def __float__(self) -> float:
        return self.sel


class SelectivityEstimator:
    """Estimates predicate selectivity from precomputed dataset statistics,
    with an exact bitmap-index fast path when an ``AttributeIndex`` (and
    optionally a shared ``PredicateCache``) is attached."""

    def __init__(self, stats: DatasetStats, index=None, cache=None):
        self.stats = stats
        self.index = index          # Optional[repro_torch.filter.AttributeIndex]
        self.cache = cache          # Optional[repro_torch.filter.PredicateCache]
        self.model: Optional[GradientBoostingRegressor] = None
        # bumped by fit(): estimates change when the GBM retrains, so
        # anything memoising estimates (the engine's PlanCache) keys its
        # validity on this generation
        self.generation = 0
        # the engine's LiveCorpus, attached by build_stats(): its tombstones
        # compose out of the exact fast path's popcount
        self.live = None
        # the engine's tracer (set_tracer): each predicate-cache miss of the
        # exact path compiles under a ``bitmap_compile`` span
        self.tracer = NULL_TRACER

    # ------------------------------------------------------------------
    def features(self, pred: Predicate) -> np.ndarray:
        """Lightweight feature vector for the GBM (paper §3.2.1/§3.2.3)."""
        st = self.stats
        lbls = label_ids(pred, st.cat_offsets)
        f = np.zeros(N_FEATURES, dtype=np.float64)

        # label features
        f[0] = st.independence_sel(pred)
        pairs = list(combinations(lbls, 2))
        if pairs:
            joints = [st.pair_joint_sel(a, b) for a, b in pairs]
            pmis = [st.pmi(a, b) for a, b in pairs]
            f[1] = float(np.mean(joints))
            f[2] = float(np.min(joints))
            f[3] = float(np.mean(pmis))
        elif lbls:
            s = st.single_label_sel(lbls[0])
            f[1] = f[2] = s
        f[4] = float(len(lbls))

        # range features (short-circuited to zero when no ranges, paper §3.2.1)
        if pred.ranges:
            rsel = 1.0
            width = mid = 0.0
            for r in pred.ranges:
                rsel *= st.range_sel(r)
                h = st.hists[r.attr]
                dom = max(h.hi - h.lo, 1e-12)
                width += r.total_width / dom
                mid += (r.midpoint - h.lo) / dom
            f[5] = rsel
            f[6] = width / len(pred.ranges)
            f[7] = mid / len(pred.ranges)
            f[8] = float(
                sum(st.label_range_joint(l, r) for l in lbls for r in pred.ranges)
            )
        return f

    # ------------------------------------------------------------------
    def fit(self, preds: Sequence[Predicate], true_sel: Sequence[float]) -> "SelectivityEstimator":
        """Train the GBM refinement on (predicate, ground-truth selectivity)
        pairs — in the paper these ground truths come from the same training
        queries used for the planner, measured on the sampled subset.

        The GBM only ever *serves* conjunctive predicates — ``Or`` shapes
        decompose per clause in :meth:`estimate`, and the engine's ``fit``
        decomposes DNF training traffic into (disjunct, clause-truth) pairs
        before calling here — so any ``Or`` entry still in the pool is
        skipped rather than crashing feature extraction."""
        pairs = [
            (p, s) for p, s in zip(preds, true_sel) if isinstance(p, Predicate)
        ]
        if not pairs:
            return self
        x = np.stack([self.features(p) for p, _ in pairs])
        y = np.asarray([s for _, s in pairs], dtype=np.float64)
        # Predict in logit space for stability near 0.
        eps = 1e-6
        z = np.log((y + eps) / (1 - y + eps))
        self.model = GradientBoostingRegressor().fit(x, z)
        self.generation += 1
        return self

    # ------------------------------------------------------------------
    def _exact_sel(self, pred) -> float:
        """Exact selectivity from the compiled bitmap's popcount; shares the
        engine-wide predicate cache so plan-then-execute compiles once.

        Under a live corpus with deletes, the stored bitmap still has
        tombstoned rows' bits set (deletes never rewrite the index);
        exactness is preserved by composing the tombstone words out here:
        ``popcount(words ANDNOT tomb) / live_count``."""
        compiled = (self.cache.get_or_compile(pred, self.index, tracer=self.tracer)
                    if self.cache is not None else self.index.compile(pred))
        live = self.live
        if live is not None and live.n_deleted:
            from ..filter.bitmap import popcount_words, word_andnot

            tomb = live.tomb[: compiled.words.size]
            alive = popcount_words(
                word_andnot(compiled.words, tomb, compiled.n))
            denom = live.live_count if compiled.n == live.n_total else max(
                compiled.n - live.n_deleted, 1)
            return alive / denom if denom else 0.0
        return compiled.selectivity

    def _leaf_sel(self, term) -> float:
        """Marginal selectivity of one leaf (for independence corrections)."""
        st = self.stats
        if isinstance(term, LabelEq):
            # out-of-dictionary codes match nothing; the card bound also
            # stops a too-large code aliasing into the NEXT attribute's
            # global-id span
            if not (0 <= term.attr < len(st.cat_cards)):
                return 0.0
            if not (0 <= term.code < st.cat_cards[term.attr]):
                return 0.0
            return st.single_label_sel(st.cat_offsets[term.attr] + term.code)
        return st.range_sel(term)

    def _route(self, pred):
        """Shared routing for conjunctions: returns an ``("exact", s)``
        index-backed truth, a direct ``("value", s)`` estimate, or
        ``("gbm", features)`` when the predicate needs the model (so a
        batch can pool its GBM rows into one predict).  ``Or`` predicates
        never reach here — :meth:`estimate` decomposes them per clause."""
        st = self.stats

        # exact fast path: an index that covers every leaf answers with a
        # popcount — bypassing histograms and the GBM entirely
        if self.index is not None and self.index.covers(pred):
            return "exact", self._exact_sel(pred)

        if pred.nots:
            # negated leaves scale the positive part under independence
            pos = Predicate(labels=pred.labels, ranges=pred.ranges)
            s = self.estimate(pos).sel
            for nt in pred.nots:
                s *= 1.0 - self._leaf_sel(nt.term)
            return "value", float(np.clip(s, 0.0, 1.0))

        lbls = label_ids(pred, st.cat_offsets)

        if pred.kind == "range":
            # Pure range: histograms are enough, no model (paper §3.2.2).
            s = 1.0
            for r in pred.ranges:
                s *= st.range_sel(r)
            return "value", float(np.clip(s, 0.0, 1.0))

        if pred.kind == "label":
            if len(lbls) == 1:
                return "value", st.single_label_sel(lbls[0])        # exact lookup
            if len(lbls) == 2:
                return "value", st.pair_joint_sel(lbls[0], lbls[1]) # exact matrix

        # >=3 labels or mixed: GBM refinement (falls back to independence
        # estimate if the model was never fit).
        if self.model is None:
            return "value", float(np.clip(st.independence_sel(pred), 0.0, 1.0))
        return "gbm", self.features(pred)

    def _sigmoid(self, z) -> np.ndarray:
        return np.clip(1.0 / (1.0 + np.exp(-z)), 0.0, 1.0)

    def estimate(self, pred) -> SelEstimate:
        """Estimate one predicate.

        ``Or`` predicates decompose: every conjunctive disjunct is estimated
        independently (``per_clause``, aligned with ``pred.terms``) and the
        whole-predicate value is the exact union popcount when the index
        covers the DNF, else the independence union ``1 - prod(1 - s_t)``.
        """
        if isinstance(pred, Or):
            per = tuple(self.estimate(t) for t in pred.terms)
            if self.index is not None and self.index.covers(pred):
                return SelEstimate(self._exact_sel(pred), True, per)
            s = 1.0
            for c in per:
                s *= 1.0 - c.sel
            return SelEstimate(float(np.clip(1.0 - s, 0.0, 1.0)), False, per)
        kind, payload = self._route(pred)
        if kind == "exact":
            return SelEstimate(float(payload), True)
        if kind == "value":
            return SelEstimate(float(payload), False)
        z = float(self.model.predict(payload[None, :])[0])
        return SelEstimate(float(self._sigmoid(z)), False)

    def estimate_batch(self, preds: Sequence) -> List[SelEstimate]:
        """Vectorised :meth:`estimate` over a batch of predicates.

        Conjunction GBM routes share ONE ``model.predict`` over a stacked
        (B_gbm, F) feature matrix; ``Or`` rows decompose recursively.
        Per-row tree traversal is row-independent, so results are identical
        to B independent :meth:`estimate` calls.
        """
        out: List[Optional[SelEstimate]] = [None] * len(preds)
        gbm_rows, gbm_idx = [], []
        for i, pred in enumerate(preds):
            if isinstance(pred, Or):
                out[i] = self.estimate(pred)
                continue
            kind, payload = self._route(pred)
            if kind == "exact":
                out[i] = SelEstimate(float(payload), True)
            elif kind == "value":
                out[i] = SelEstimate(float(payload), False)
            else:
                gbm_rows.append(payload)
                gbm_idx.append(i)
        if gbm_rows:
            z = self.model.predict(np.stack(gbm_rows))
            for i, s in zip(gbm_idx, self._sigmoid(z)):
                out[i] = SelEstimate(float(s), False)
        return out

    # -- deprecated tuple spellings (one release; prefer estimate/_batch) --
    def estimate_ex(self, pred) -> Tuple[float, bool]:
        """Deprecated: use :meth:`estimate` (returns :class:`SelEstimate`)."""
        se = self.estimate(pred)
        return se.sel, se.is_exact

    def estimate_batch_ex(self, preds: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        """Deprecated: use :meth:`estimate_batch`."""
        ses = self.estimate_batch(preds)
        return (np.asarray([s.sel for s in ses], np.float64),
                np.asarray([s.is_exact for s in ses], bool))
