"""Training-data preparation: controlled-selectivity query generation
(paper §3.1: "queries with controlled selectivity ... from 1% to 25%").

Predicates are constructed from the data itself so target selectivities are
achievable:

* range    — pick a numeric attribute, a random anchor quantile, and the
             window of the empirical CDF whose mass equals the target.
* label    — seed a data point, take 1-3 of its labels (conjunction is then
             guaranteed non-empty); target selectivity guides how many
             conjuncts to keep.
* mixed    — label(s) from a seed point + a range over a numeric attribute
             centred on the seed's value, widened to hit the target.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .predicates import LabelEq, Predicate, RangePred

__all__ = ["gen_queries", "gen_predicate"]


def _range_for_target(
    x_sorted: np.ndarray, target: float, rng: np.random.Generator
) -> Tuple[float, float]:
    """Empirical-CDF window of mass ``target`` at a random anchor."""
    n = x_sorted.size
    w = max(1, int(round(target * n)))
    lo_i = int(rng.integers(0, max(1, n - w)))
    hi_i = min(n - 1, lo_i + w)
    lo = float(x_sorted[lo_i])
    hi = float(x_sorted[hi_i])
    if hi <= lo:
        hi = lo + 1e-6
    return lo, hi


def gen_predicate(
    cat: np.ndarray,
    num: np.ndarray,
    target_sel: float,
    kind: str,
    rng: np.random.Generator,
    sorted_num: Optional[List[np.ndarray]] = None,
    multi_range_prob: float = 0.2,
) -> Predicate:
    a_cat = cat.shape[1] if cat.size else 0
    a_num = num.shape[1] if num.size else 0
    if sorted_num is None:
        sorted_num = [np.sort(num[:, j]) for j in range(a_num)]

    if kind == "range":
        attr = int(rng.integers(a_num))
        if rng.random() < multi_range_prob:
            # union of two disjoint ranges over the same attribute (§3.2.2)
            lo1, hi1 = _range_for_target(sorted_num[attr], target_sel / 2, rng)
            lo2, hi2 = _range_for_target(sorted_num[attr], target_sel / 2, rng)
            if lo2 < hi1 and lo1 < hi2:   # overlapped -> merge into one
                ivs = ((min(lo1, lo2), max(hi1, hi2)),)
            else:
                ivs = ((lo1, hi1), (lo2, hi2))
            return Predicate(ranges=(RangePred(attr, ivs),))
        lo, hi = _range_for_target(sorted_num[attr], target_sel, rng)
        return Predicate(ranges=(RangePred(attr, ((lo, hi),)),))

    # label / mixed: anchor on a random data point so conjunctions are
    # guaranteed satisfiable.
    seed_row = int(rng.integers(cat.shape[0]))
    n_lbl = 1 if kind == "mixed" else int(rng.integers(1, min(3, a_cat) + 1))
    attrs = rng.choice(a_cat, size=n_lbl, replace=False)
    labels = tuple(
        LabelEq(int(a), int(cat[seed_row, a])) for a in attrs if cat[seed_row, a] >= 0
    )
    if kind == "label":
        return Predicate(labels=labels)

    # mixed: add a range centred on the seed's numeric value sized for target
    attr = int(rng.integers(a_num))
    xs = sorted_num[attr]
    seed_v = float(num[seed_row, attr])
    pos = int(np.searchsorted(xs, seed_v))
    w = max(1, int(round(target_sel * xs.size)))
    lo_i = max(0, pos - w // 2)
    hi_i = min(xs.size - 1, lo_i + w)
    lo, hi = float(xs[lo_i]), float(xs[hi_i])
    if hi <= lo:
        hi = lo + 1e-6
    return Predicate(labels=labels, ranges=(RangePred(attr, ((lo, hi),)),))


def gen_queries(
    vectors: np.ndarray,
    cat: np.ndarray,
    num: np.ndarray,
    n_queries: int,
    kinds: Sequence[str] = ("range",),
    sel_range: Tuple[float, float] = (0.01, 0.25),
    noise: float = 0.05,
    seed: int = 0,
) -> Tuple[np.ndarray, List[Predicate], np.ndarray]:
    """Returns (query_vectors (Q,d), predicates, true_selectivities (Q,)).

    Query vectors are perturbed corpus points (the standard filtered-ANN
    query model); predicates hit selectivities sampled log-uniformly in
    ``sel_range``; queries whose predicate came out empty are resampled.
    """
    rng = np.random.default_rng(seed)
    a_num = num.shape[1] if num.size else 0
    sorted_num = [np.sort(num[:, j]) for j in range(a_num)]
    qs, preds, sels = [], [], []
    scale = float(np.std(vectors)) * noise
    while len(preds) < n_queries:
        kind = kinds[int(rng.integers(len(kinds)))]
        t = float(np.exp(rng.uniform(np.log(sel_range[0]), np.log(sel_range[1]))))
        p = gen_predicate(cat, num, t, kind, rng, sorted_num)
        true = p.selectivity(cat, num)
        if true <= 0:
            continue
        row = int(rng.integers(vectors.shape[0]))
        q = vectors[row] + rng.normal(0, scale, size=vectors.shape[1]).astype(np.float32)
        qs.append(q)
        preds.append(p)
        sels.append(true)
    return np.stack(qs).astype(np.float32), preds, np.asarray(sels)
