"""Core planner: learned execution-strategy classifier (paper §3.3).

Port of ``repro/core/planner.py``.  A two-hidden-layer MLP (widths 64 and
32, ReLU, softmax; an ``nn.Module``) maps query+dataset features to a binary
decision: PRE_FILTER (0) vs POST_FILTER (1).  Trained with Adam (lr 1e-3,
moments 0.9/0.999, eps 1e-8), batch size 200, up to 500 epochs, L2 inside
the loss and early stopping; the L2 strength is grid-searched with
cross-validated ROC-AUC as the objective.

:meth:`CorePlanner.decide` is 3-way: rows the head sends to pre-filtering
are promoted to INDEXED_PRE (2) when the predicate is covered by the
attribute index (the ``sel_is_exact`` feature).  The routing head is the
reference's numpy softmax regression, copied; the engine of this slice
never routes, but its state travels through ``state_dict``/``load_state``.

The weights are initialised from a ``torch.Generator`` and cannot equal the
reference's ``jax.random`` draw; the two are compared by loading one state
into both (:mod:`repro_torch.carry`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device, strict_fp32
from .predicates import Predicate
from .stats import DatasetStats

__all__ = [
    "CorePlanner", "PlannerFeatures", "PlannerMLP",
    "PRE_FILTER", "POST_FILTER", "INDEXED_PRE",
    "roc_auc",
]

PRE_FILTER = 0
POST_FILTER = 1
INDEXED_PRE = 2     # pre-filter via the bitmap attribute index (repro_torch.filter)

_HIDDEN = (64, 32)   # paper §3.3
_EPOCHS = 500
_BATCH = 200
_LR = 1e-3
_PATIENCE = 15

# routing head: full-batch GD softmax regression, fixed iteration count —
# deterministic by construction (float64 accumulation)
_ROUTE_ITERS = 400
_ROUTE_LR = 0.5
_ROUTE_L2 = 1e-3


def _encode_names(names: Sequence[str]) -> np.ndarray:
    """Class names -> fixed-width uint8 matrix (the reference's checkpoint
    encoding)."""
    bs = [n.encode("utf-8") for n in names]
    width = max(len(b) for b in bs) if bs else 1
    out = np.zeros((len(bs), width), np.uint8)
    for i, b in enumerate(bs):
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


def _decode_names(arr: np.ndarray) -> Tuple[str, ...]:
    a = np.asarray(arr, np.uint8)
    return tuple(bytes(row).rstrip(b"\x00").decode("utf-8") for row in a)


def roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """ROC-AUC via the rank statistic (Mann-Whitney U)."""
    y_true = np.asarray(y_true)
    scores = np.asarray(scores, dtype=np.float64)
    pos = scores[y_true == 1]
    neg = scores[y_true == 0]
    if pos.size == 0 or neg.size == 0:
        return 0.5
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(order.size)
    ranks[order] = np.arange(1, order.size + 1)
    # midranks for ties
    allv = np.concatenate([pos, neg])
    sorted_v = np.sort(allv)
    uniq, start = np.unique(sorted_v, return_index=True)
    for i, v in enumerate(uniq):
        end = start[i + 1] if i + 1 < uniq.size else sorted_v.size
        tie_rows = allv == v
        ranks[tie_rows] = 0.5 * (start[i] + 1 + end)
    r_pos = ranks[: pos.size].sum()
    u = r_pos - pos.size * (pos.size + 1) / 2.0
    return float(u / (pos.size * neg.size))


# ----------------------------------------------------------------------
# feature construction
# ----------------------------------------------------------------------
@dataclasses.dataclass
class PlannerFeatures:
    """Feature extractor: dataset stats + per-query predicate info."""

    stats: DatasetStats

    N_FEATURES = 10
    SEL_COL = 3          # estimated selectivity
    SEL_EXACT_COL = 9    # 1.0 when the estimate is an exact index popcount

    def vector(self, pred: Predicate, est_sel: float, k: int,
               sel_exact: bool = False) -> np.ndarray:
        st = self.stats
        kind_onehot = {"label": (1, 0, 0), "range": (0, 1, 0), "mixed": (0, 0, 1)}[pred.kind]
        return np.array(
            [
                np.log10(max(st.n, 1)),          # corpus size
                st.dim / 1000.0,                 # dimensionality
                st.dist_measure,                 # vector-distribution measure
                est_sel,                         # estimated selectivity
                np.log10(est_sel + 1e-6),        # log-scale selectivity
                np.log2(max(k, 1)),              # requested k
                *kind_onehot,                    # predicate type
                float(sel_exact),                # exact index-backed selectivity?
            ],
            dtype=np.float32,
        )

    _KIND_COL = {"label": 6, "range": 7, "mixed": 8}

    def matrix(self, preds: Sequence[Predicate], est_sels: np.ndarray, k: int,
               sel_exact: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched :meth:`vector`: one (B, F) matrix, row i == vector(preds[i])."""
        b = len(preds)
        st = self.stats
        es = np.asarray(est_sels, np.float64)
        f = np.zeros((b, self.N_FEATURES), np.float32)
        f[:, 0] = np.log10(max(st.n, 1))
        f[:, 1] = st.dim / 1000.0
        f[:, 2] = st.dist_measure
        f[:, 3] = es
        f[:, 4] = np.log10(es + 1e-6)
        f[:, 5] = np.log2(max(k, 1))
        for i, p in enumerate(preds):
            f[i, self._KIND_COL[p.kind]] = 1.0
        if sel_exact is not None:
            f[:, self.SEL_EXACT_COL] = np.asarray(sel_exact, np.float32)
        return f


# ----------------------------------------------------------------------
# the MLP
# ----------------------------------------------------------------------
class PlannerMLP(nn.Module):
    """features -> 64 -> 32 -> 2 logits, ReLU between."""

    def __init__(self, n_features: int):
        super().__init__()
        h1, h2 = _HIDDEN
        self.l1 = nn.Linear(n_features, h1)
        self.l2 = nn.Linear(h1, h2)
        self.l3 = nn.Linear(h2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.l1(x))
        h = torch.relu(self.l2(h))
        return self.l3(h)

    def reset(self, gen: torch.Generator) -> "PlannerMLP":
        """Glorot-normal weights from ``gen``, zero biases (the reference's
        init scheme, not its draw)."""
        with torch.no_grad():
            for lin in (self.l1, self.l2, self.l3):
                fan_out, fan_in = lin.weight.shape
                s = float(np.sqrt(2.0 / (fan_in + fan_out)))
                w = torch.randn((fan_out, fan_in), generator=gen) * s
                lin.weight.copy_(w)
                lin.bias.zero_()
        return self

    def l2_penalty(self) -> torch.Tensor:
        return sum((lin.weight ** 2).sum() for lin in (self.l1, self.l2, self.l3))


class CorePlanner:
    """Binary execution-strategy classifier."""

    def __init__(self, n_features: int = PlannerFeatures.N_FEATURES, seed: int = 0,
                 device=DEFAULT_DEVICE):
        self.n_features = n_features
        self.device = resolve_device(device)
        # the head sees every feature EXCEPT sel_is_exact, which only drives
        # the indexed-pre promotion in decide()
        self._head_cols = [
            i for i in range(n_features) if i != PlannerFeatures.SEL_EXACT_COL
        ]
        self.n_head = len(self._head_cols)
        self.seed = seed
        self.params: Optional[PlannerMLP] = None
        self.mu = np.zeros(self.n_head, np.float32)
        self.sigma = np.ones(self.n_head, np.float32)
        self.best_l2_: float = 1e-4
        self.val_auc_: float = 0.5
        # bumped by fit()/load_state(): the engine's PlanCache keys on it
        self.generation = 0
        self._route: Optional[Dict[str, np.ndarray]] = None
        self._route_classes: Optional[Tuple[str, ...]] = None

    # ------------------------------------------------------------------
    def _proba(self, mlp: PlannerMLP, xn: np.ndarray) -> np.ndarray:
        strict_fp32()
        with torch.no_grad():
            x = torch.as_tensor(xn, dtype=torch.float32, device=self.device)
            return torch.softmax(mlp(x), dim=1)[:, 1].cpu().numpy()

    def _train_once(self, x, y, l2, seed, val_x=None, val_y=None):
        strict_fp32()
        gen = torch.Generator().manual_seed(seed)
        mlp = PlannerMLP(self.n_head).reset(gen).to(self.device)
        opt = torch.optim.Adam(mlp.parameters(), lr=_LR, betas=(0.9, 0.999), eps=1e-8)
        n = x.shape[0]
        rng = np.random.default_rng(seed)
        xt = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        yt = torch.as_tensor(y, dtype=torch.int64, device=self.device)

        def loss_fn(xb, yb, reg):
            ce = nn.functional.cross_entropy(mlp(xb), yb)
            return ce + reg * mlp.l2_penalty()

        best_metric, best_state, bad = -np.inf, copy.deepcopy(mlp.state_dict()), 0
        for _ in range(_EPOCHS):
            perm = torch.as_tensor(rng.permutation(n), device=self.device)
            for s in range(0, n, _BATCH):
                idx = perm[s : s + _BATCH]
                opt.zero_grad(set_to_none=True)
                loss_fn(xt[idx], yt[idx], l2).backward()
                opt.step()
            if val_x is not None and val_x.shape[0]:
                metric = roc_auc(val_y, self._proba(mlp, val_x))
            else:
                with torch.no_grad():
                    metric = -float(loss_fn(xt, yt, 0.0))
            if metric > best_metric + 1e-5:
                best_metric, best_state, bad = metric, copy.deepcopy(mlp.state_dict()), 0
            else:
                bad += 1
                if bad >= _PATIENCE:
                    break
        mlp.load_state_dict(best_state)
        return mlp, best_metric

    def fit(
        self,
        features: np.ndarray,
        labels: np.ndarray,
        l2_grid: Sequence[float] = (1e-4, 1e-3),
        n_folds: int = 2,
    ) -> "CorePlanner":
        x = np.asarray(features, np.float32)[:, self._head_cols]
        y = np.asarray(labels, np.int32)
        self.mu = x.mean(0)
        self.sigma = x.std(0) + 1e-6
        xn = (x - self.mu) / self.sigma

        # small grid search over L2 with k-fold CV, ROC-AUC objective
        n = xn.shape[0]
        if n >= 3 * n_folds and len(set(y.tolist())) > 1:
            folds = np.arange(n) % n_folds
            rng = np.random.default_rng(self.seed)
            folds = folds[rng.permutation(n)]
            best_auc, best_l2 = -np.inf, l2_grid[0]
            for l2 in l2_grid:
                aucs = []
                for f in range(n_folds):
                    tr, va = folds != f, folds == f
                    if y[va].min() == y[va].max():
                        continue
                    _, auc = self._train_once(xn[tr], y[tr], l2, self.seed + f, xn[va], y[va])
                    aucs.append(auc)
                mean_auc = float(np.mean(aucs)) if aucs else -np.inf
                if mean_auc > best_auc:
                    best_auc, best_l2 = mean_auc, l2
            self.best_l2_, self.val_auc_ = best_l2, best_auc
        # final fit on all data with the selected L2 (held-out slice for early
        # stop; skipped when it would leave no training rows)
        n_val = max(4, n // 10)
        if n_val >= n:
            n_val = 0
        perm = np.random.default_rng(self.seed).permutation(n)
        va, tr = perm[:n_val], perm[n_val:]
        val_ok = n_val > 0 and len(set(y[va].tolist())) > 1
        self.params, _ = self._train_once(
            xn[tr], y[tr], self.best_l2_, self.seed,
            xn[va] if val_ok else None, y[va] if val_ok else None,
        )
        self.generation += 1
        return self

    # ------------------------------------------------------------------
    def predict_proba(self, features: np.ndarray) -> np.ndarray:
        """P(post-filter is the better strategy) per query; (F,) or (B, F)."""
        assert self.params is not None, "planner not trained"
        x = np.atleast_2d(features).astype(np.float32)[:, self._head_cols]
        return self._proba(self.params, (x - self.mu) / self.sigma)

    def decide(self, features: np.ndarray) -> np.ndarray:
        """3-way decision per query row: 0 = pre-filter (columnar scan),
        1 = post-filter, 2 = indexed pre-filter (a covered predicate the
        head sends to pre-filtering)."""
        x = np.atleast_2d(np.asarray(features, np.float32))
        base = (self.predict_proba(x) >= 0.5).astype(np.int32)
        if x.shape[1] <= PlannerFeatures.SEL_EXACT_COL:
            return base                      # legacy feature layout: 2-way only
        promote = (base == PRE_FILTER) & (
            x[:, PlannerFeatures.SEL_EXACT_COL] >= 0.5
        )
        return np.where(promote, INDEXED_PRE, base).astype(np.int32)

    # ------------------------------------------------------------------
    # routing head: (backend, knob-tier) class on top of the plan decision
    # ------------------------------------------------------------------
    @property
    def route_classes(self) -> Optional[Tuple[str, ...]]:
        return self._route_classes

    def fit_routing(
        self,
        features: np.ndarray,
        route_labels: np.ndarray,
        class_names: Sequence[str],
        iters: int = _ROUTE_ITERS,
        lr: float = _ROUTE_LR,
        l2: float = _ROUTE_L2,
    ) -> "CorePlanner":
        """Fit the routing head on utility-race argmax labels (rows with a
        negative label are ignored); full-batch float64 gradient descent."""
        x = np.atleast_2d(np.asarray(features, np.float64))
        y = np.asarray(route_labels, np.int64).reshape(-1)
        keep = y >= 0
        x, y = x[keep], y[keep]
        n_classes = len(class_names)
        if x.shape[0] == 0 or n_classes == 0:
            return self
        mu = x.mean(0)
        sigma = x.std(0) + 1e-6
        xn = (x - mu) / sigma
        n, f = xn.shape
        w = np.zeros((f, n_classes), np.float64)
        b = np.zeros(n_classes, np.float64)
        onehot = np.zeros((n, n_classes), np.float64)
        onehot[np.arange(n), y] = 1.0
        for _ in range(iters):
            logits = xn @ w + b
            logits -= logits.max(axis=1, keepdims=True)
            p = np.exp(logits)
            p /= p.sum(axis=1, keepdims=True)
            g = (p - onehot) / n
            w -= lr * (xn.T @ g + l2 * w)
            b -= lr * g.sum(0)
        self._route = {
            "w": w.astype(np.float32),
            "b": b.astype(np.float32),
            "mu": mu.astype(np.float32),
            "sigma": sigma.astype(np.float32),
        }
        self._route_classes = tuple(class_names)
        self.generation += 1
        return self

    def route(self, features: np.ndarray) -> Optional[np.ndarray]:
        """Routing class index per row, or None when no head is fitted."""
        if self._route is None:
            return None
        x = np.atleast_2d(np.asarray(features, np.float32)).astype(np.float64)
        r = self._route
        xn = (x - r["mu"].astype(np.float64)) / r["sigma"].astype(np.float64)
        logits = xn @ r["w"].astype(np.float64) + r["b"].astype(np.float64)
        return np.argmax(logits, axis=1).astype(np.int32)

    # ------------------------------------------------------------------
    # state in the reference's format: params w1..b3 with w as (in, out)
    # ------------------------------------------------------------------
    _LAYERS = (("w1", "b1", "l1"), ("w2", "b2", "l2"), ("w3", "b3", "l3"))

    def state_dict(self) -> Dict:
        assert self.params is not None, "planner not trained"
        params = {}
        for wn, bn, ln in self._LAYERS:
            lin = getattr(self.params, ln)
            params[wn] = lin.weight.detach().T.cpu().numpy().copy()
            params[bn] = lin.bias.detach().cpu().numpy().copy()
        state: Dict = {
            "params": params,
            "mu": np.asarray(self.mu),
            "sigma": np.asarray(self.sigma),
            "meta": np.asarray([self.n_features, self.seed], np.int32),
        }
        if self._route is not None:
            state["route"] = {
                **{k: np.asarray(v) for k, v in self._route.items()},
                "classes": _encode_names(self._route_classes or ()),
            }
        return state

    def load_state(self, state: Dict) -> "CorePlanner":
        """Inverse of :meth:`state_dict`; takes any array-like leaves (the
        reference planner's ``state_dict()`` loads as it is)."""
        p = state["params"]
        mlp = PlannerMLP(np.asarray(p["w1"]).shape[0])
        with torch.no_grad():
            for wn, bn, ln in self._LAYERS:
                lin = getattr(mlp, ln)
                lin.weight.copy_(torch.tensor(np.asarray(p[wn], np.float32).T))
                lin.bias.copy_(torch.tensor(np.asarray(p[bn], np.float32)))
        self.params = mlp.to(self.device)
        self.mu = np.asarray(state["mu"], np.float32)
        self.sigma = np.asarray(state["sigma"], np.float32)
        route = state.get("route")
        if route is not None:
            self._route = {
                k: np.asarray(route[k], np.float32)
                for k in ("w", "b", "mu", "sigma")
            }
            self._route_classes = _decode_names(np.asarray(route["classes"]))
        else:
            self._route = None
            self._route_classes = None
        self.generation += 1
        return self
