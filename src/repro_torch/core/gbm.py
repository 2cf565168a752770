"""Gradient-boosted regression trees, pure numpy.

The paper trains "a Gradient Boosting Model ... with 300 estimators, maximum
depth 4, and a learning rate of 0.05" (§3.2.1) to refine multi-label / mixed
selectivity estimates.  sklearn is unavailable in this offline container, so
this is a from-scratch least-squares GBM: quantile-candidate splits, depth-
limited CART regression trees, shrinkage.

Feature matrices here are tiny (thousands of rows x ~10 columns), so exact
vectorised split scans are fast enough; no histogram binning subtleties
needed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["GradientBoostingRegressor", "RegressionTree"]


@dataclasses.dataclass
class _Node:
    feature: int = -1          # -1 => leaf
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class RegressionTree:
    """CART regression tree with squared-error splits."""

    def __init__(self, max_depth: int = 4, min_samples_leaf: int = 4, n_thresholds: int = 32):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.n_thresholds = n_thresholds
        self.nodes: List[_Node] = []

    # ------------------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray) -> "RegressionTree":
        self.nodes = []
        self._grow(x, y, depth=0)
        return self

    def _grow(self, x: np.ndarray, y: np.ndarray, depth: int) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(y.mean()) if y.size else 0.0))
        if depth >= self.max_depth or y.size < 2 * self.min_samples_leaf or np.ptp(y) == 0:
            return idx
        feat, thr = self._best_split(x, y)
        if feat < 0:
            return idx
        mask = x[:, feat] <= thr
        left = self._grow(x[mask], y[mask], depth + 1)
        right = self._grow(x[~mask], y[~mask], depth + 1)
        node = self.nodes[idx]
        node.feature, node.threshold, node.left, node.right = feat, thr, left, right
        return idx

    def _best_split(self, x: np.ndarray, y: np.ndarray):
        n, d = x.shape
        best_gain, best = 0.0, (-1, 0.0)
        total_sum, total_cnt = y.sum(), n
        parent_sse_term = total_sum * total_sum / total_cnt
        for f in range(d):
            col = x[:, f]
            # Candidate thresholds at quantiles of the column.
            qs = np.unique(np.quantile(col, np.linspace(0.02, 0.98, self.n_thresholds)))
            if qs.size == 0:
                continue
            # For each candidate, split stats via vectorised comparison.
            le = col[None, :] <= qs[:, None]               # (T, n)
            cnt_l = le.sum(1).astype(np.float64)           # (T,)
            sum_l = (le * y[None, :]).sum(1)
            cnt_r = total_cnt - cnt_l
            sum_r = total_sum - sum_l
            ok = (cnt_l >= self.min_samples_leaf) & (cnt_r >= self.min_samples_leaf)
            if not ok.any():
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                gain = sum_l * sum_l / cnt_l + sum_r * sum_r / cnt_r - parent_sse_term
            gain = np.where(ok, gain, -np.inf)
            t = int(np.argmax(gain))
            if gain[t] > best_gain:
                best_gain, best = float(gain[t]), (f, float(qs[t]))
        return best

    # ------------------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        if not self.nodes:
            return np.zeros(x.shape[0])
        out = np.empty(x.shape[0], dtype=np.float64)
        # Iterative traversal per point; trees are tiny (depth<=4 => <=31 nodes)
        # and batches small, so a simple frontier walk is fine.
        stack = [(0, np.arange(x.shape[0]))]
        while stack:
            node_idx, rows = stack.pop()
            node = self.nodes[node_idx]
            if node.feature < 0:
                out[rows] = node.value
                continue
            mask = x[rows, node.feature] <= node.threshold
            stack.append((node.left, rows[mask]))
            stack.append((node.right, rows[~mask]))
        return out


class GradientBoostingRegressor:
    """Least-squares GBM with shrinkage (paper config: 300/4/0.05)."""

    def __init__(
        self,
        n_estimators: int = 300,
        max_depth: int = 4,
        learning_rate: float = 0.05,
        min_samples_leaf: int = 4,
        early_stopping_rounds: Optional[int] = 25,
        validation_fraction: float = 0.1,
        seed: int = 0,
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.min_samples_leaf = min_samples_leaf
        self.early_stopping_rounds = early_stopping_rounds
        self.validation_fraction = validation_fraction
        self.seed = seed
        self.base_: float = 0.0
        self.trees_: List[RegressionTree] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GradientBoostingRegressor":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        n = x.shape[0]
        self.trees_ = []
        self.base_ = float(y.mean()) if n else 0.0

        # hold-out for early stopping
        use_es = self.early_stopping_rounds is not None and n >= 50
        if use_es:
            perm = rng.permutation(n)
            n_val = max(8, int(self.validation_fraction * n))
            val_idx, tr_idx = perm[:n_val], perm[n_val:]
            xt, yt, xv, yv = x[tr_idx], y[tr_idx], x[val_idx], y[val_idx]
        else:
            xt, yt = x, y
            xv = yv = None

        f_tr = np.full(yt.shape, self.base_)
        f_val = np.full(yv.shape, self.base_) if use_es else None
        best_val, best_len, rounds_bad = np.inf, 0, 0

        for _ in range(self.n_estimators):
            resid = yt - f_tr
            tree = RegressionTree(self.max_depth, self.min_samples_leaf).fit(xt, resid)
            self.trees_.append(tree)
            f_tr += self.learning_rate * tree.predict(xt)
            if use_es:
                f_val += self.learning_rate * tree.predict(xv)
                val_mse = float(((yv - f_val) ** 2).mean())
                if val_mse < best_val - 1e-12:
                    best_val, best_len, rounds_bad = val_mse, len(self.trees_), 0
                else:
                    rounds_bad += 1
                    if rounds_bad >= self.early_stopping_rounds:
                        self.trees_ = self.trees_[:best_len]
                        break
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        out = np.full(x.shape[0], self.base_, dtype=np.float64)
        for tree in self.trees_:
            out += self.learning_rate * tree.predict(x)
        return out
