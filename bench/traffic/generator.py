"""The one traffic generator: a mix file's parameters -> a stream of queries.

A frozen copy of the program's ``core/trainer.py::gen_predicate`` and
``gen_queries``, repaired for a benchmark:

* predicates come out in a neutral form (below) that the reference reads
  on its own, and :func:`to_program` turns into the program's IR;
* there is no rejection loop that evaluates a full mask per predicate:
  ranges cut from the empirical CDF and labels anchored on a row pass at
  least one row by construction, and the rare empty one stays in the stream
  as a real query;
* a degenerate range ``[lo, lo)`` becomes ``[lo, nextafter(lo))``, so every
  bound is a float32 value and the predicate passes the rows equal to
  ``lo`` under float32 and float64 comparison alike;
* every query vector, predicate and Zipf index is drawn from the run's seed.

A predicate is ``(labels, ranges)``: ``labels`` a sorted tuple of ``(attr,
code)`` equalities, ``ranges`` a sorted tuple of ``(attr, ((lo, hi), ...))``
unions of half-open intervals over one numeric attribute; all of them hold.

A mix file (``bench/traffic/<mix>.json``) holds::

    batch, k, noise          queries per batch_query call, neighbours, query noise
    max_qps                  the stream holds max_qps * seconds queries
    warmup_batches           batches sent before the window (same traffic)
    predicates.mode          "pool": a pool of distinct predicates, each query
                             takes one by a Zipf(zipf) rank; "fresh": every
                             query draws its own
    predicates.unique        fresh mode: a predicate is never repeated in a run
    predicates.pool, .zipf   pool size and exponent (pool mode)
    predicates.kinds         "range", "label" or "mixed", equally likely
    predicates.pass_fraction fresh: target pass fractions, log-uniform [lo, hi];
                             pool: the targets, log-spaced over [lo, hi]
    predicates.multi_range_prob  chance that a range is a union of two

A pool has the same set of sizes in every run: rank r aims at a fixed
target pass fraction, and of ``POOL_CANDIDATES`` predicates drawn from the
seed keeps the one whose pass fraction is nearest it (by log).  Which
predicates those are, and so which rows they pass, comes from the seed.
The targets go to the ranks in one fixed shuffled order
(``POOL_RANK_ORDER_SEED``), the same in every run and every pool mix: a
filter's popularity is taken to say nothing of how many rows it passes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["gen_predicate", "make_predicates", "to_program", "pass_fraction_target"]

POOL_CANDIDATES = 64         # draws a pool rank keeps the nearest of
POOL_RANK_ORDER_SEED = 0     # the fixed shuffle from Zipf rank to target

Pred = Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[int, Tuple[Tuple[float, float], ...]], ...]]


def _up(x: np.float32) -> float:
    return float(np.nextafter(np.float32(x), np.float32(np.inf)))


def _range_for_target(xs: np.ndarray, target: float, rng: np.random.Generator):
    """Empirical-CDF window of mass ``target`` at a random anchor."""
    n = xs.size
    w = max(1, int(round(target * n)))
    lo_i = int(rng.integers(0, max(1, n - w)))
    hi_i = min(n - 1, lo_i + w)
    lo, hi = float(xs[lo_i]), float(xs[hi_i])
    if hi <= lo:
        hi = _up(xs[lo_i])
    return lo, hi


def _merge(ivs) -> Tuple[Tuple[float, float], ...]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(ivs):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def gen_predicate(cat: np.ndarray, num: np.ndarray, sorted_num: Sequence[np.ndarray],
                  target: float, kind: str, rng: np.random.Generator,
                  multi_range_prob: float = 0.2) -> Pred:
    """One predicate of ``kind`` aimed at pass fraction ``target``."""
    a_cat, a_num = cat.shape[1], num.shape[1]
    if kind == "range":
        attr = int(rng.integers(a_num))
        if rng.random() < multi_range_prob:
            lo1, hi1 = _range_for_target(sorted_num[attr], target / 2, rng)
            lo2, hi2 = _range_for_target(sorted_num[attr], target / 2, rng)
            return (), ((attr, _merge([(lo1, hi1), (lo2, hi2)])),)
        return (), ((attr, (_range_for_target(sorted_num[attr], target, rng),)),)
    if kind not in ("label", "mixed"):
        raise ValueError(f"unknown predicate kind {kind!r}")
    row = int(rng.integers(cat.shape[0]))
    n_lbl = 1 if kind == "mixed" else int(rng.integers(1, min(3, a_cat) + 1))
    attrs = rng.choice(a_cat, size=n_lbl, replace=False)
    labels = tuple(sorted((int(a), int(cat[row, a])) for a in attrs if cat[row, a] >= 0))
    if kind == "label":
        return labels, ()
    attr = int(rng.integers(a_num))
    xs = sorted_num[attr]
    pos = int(np.searchsorted(xs, num[row, attr]))
    w = max(1, int(round(target * xs.size)))
    lo_i = max(0, pos - w // 2)
    hi_i = min(xs.size - 1, lo_i + w)
    lo, hi = float(xs[lo_i]), float(xs[hi_i])
    if hi <= lo:
        hi = _up(xs[lo_i])
    return labels, ((attr, ((lo, hi),)),)


def pass_fraction_target(spec: dict, rng: np.random.Generator) -> float:
    lo, hi = spec["pass_fraction"]
    return float(math.exp(rng.uniform(math.log(lo), math.log(hi))))


def _fresh(cat, num, sorted_num, spec, rng, n, unique: bool) -> List[Pred]:
    kinds, seen = spec["kinds"], set()
    out: List[Pred] = []
    while len(out) < n:
        kind = kinds[int(rng.integers(len(kinds)))]
        p = gen_predicate(cat, num, sorted_num, pass_fraction_target(spec, rng), kind, rng,
                          spec.get("multi_range_prob", 0.2))
        if not unique or p not in seen:
            seen.add(p)
            out.append(p)
    return out


class _PassFraction:
    """Pass fractions of label conjunctions from joint code counts (one
    bincount per attribute subset); other predicates by a full scan."""

    def __init__(self, cat: np.ndarray, num: np.ndarray):
        self.cat, self.num = cat, num
        self.cards = (cat.max(0).astype(np.int64) + 1) if cat.size else np.zeros(0, np.int64)
        self.tables: Dict[Tuple[int, ...], np.ndarray] = {}

    def __call__(self, p: Pred) -> float:
        labels, ranges = p
        n = self.cat.shape[0]
        if ranges or not labels:
            m = np.ones(n, bool)
            for a, code in labels:
                m &= self.cat[:, a] == code
            for a, ivs in ranges:
                r = np.zeros(n, bool)
                for lo, hi in ivs:
                    r |= (self.num[:, a] >= lo) & (self.num[:, a] < hi)
                m &= r
            return float(m.mean())
        attrs = tuple(a for a, _ in labels)
        if attrs not in self.tables:
            key = np.zeros(n, np.int64)
            for a in attrs:
                key = key * self.cards[a] + self.cat[:, a]
            self.tables[attrs] = np.bincount(key, minlength=int(np.prod(self.cards[list(attrs)])))
        idx = 0
        for a, code in labels:
            idx = idx * self.cards[a] + code
        return float(self.tables[attrs][idx]) / n


def _pool(cat, num, sorted_num, spec, rng) -> List[Pred]:
    n, kinds = spec["pool"], spec["kinds"]
    lo, hi = spec["pass_fraction"]
    ladder = np.exp(np.linspace(math.log(lo), math.log(hi), n))
    order = np.random.default_rng(POOL_RANK_ORDER_SEED).permutation(n)
    frac = _PassFraction(cat, num)
    floor = 1.0 / cat.shape[0]
    out: List[Pred] = []
    for r in range(n):
        target, best = float(ladder[order[r]]), None
        for _ in range(POOL_CANDIDATES):
            kind = kinds[int(rng.integers(len(kinds)))]
            p = gen_predicate(cat, num, sorted_num, target, kind, rng,
                              spec.get("multi_range_prob", 0.2))
            if p in out:
                continue
            err = abs(math.log(max(frac(p), floor)) - math.log(target))
            if best is None or err < best[0]:
                best = (err, p)
        if best is None:
            raise ValueError(f"no new predicate for pool rank {r} in {POOL_CANDIDATES} draws")
        out.append(best[1])
    return out


def make_predicates(spec: dict, cat: np.ndarray, num: np.ndarray,
                    sorted_num: Sequence[np.ndarray], n: int, seed: int) -> List[Pred]:
    """``n`` predicates of a mix's ``predicates`` spec, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    mode = spec["mode"]
    if mode == "fresh":
        return _fresh(cat, num, sorted_num, spec, rng, n, spec.get("unique", False))
    if mode == "pool":
        pool = _pool(cat, num, sorted_num, spec, rng)
        p = 1.0 / np.arange(1, len(pool) + 1, dtype=np.float64) ** spec["zipf"]
        idx = rng.choice(len(pool), size=n, p=p / p.sum())
        return [pool[i] for i in idx]
    raise ValueError(f"unknown predicate mode {mode!r}")


def to_program(preds: Sequence[Pred]) -> List[object]:
    """The program's IR for each predicate; a repeated one maps to one object."""
    from repro_torch.core.predicates import LabelEq, Predicate, RangePred

    made: Dict[Pred, object] = {}
    out = []
    for p in preds:
        obj = made.get(p)
        if obj is None:
            labels, ranges = p
            obj = made[p] = Predicate(labels=tuple(LabelEq(a, c) for a, c in labels),
                                      ranges=tuple(RangePred(a, ivs) for a, ivs in ranges))
        out.append(obj)
    return out
