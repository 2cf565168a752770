"""Execution strategies for filtered ANN queries (paper §4.1 Methods).

Port of ``repro/core/executors.py``:

* :class:`PreFilterExec`        — filter first, exact masked top-k over the
  passing rows.  The predicate mask comes from a columnar scan on the host.
* :class:`IndexedPreFilterExec` — the same exact top-k, with the mask
  answered by the bitmap attribute index (``repro_torch.filter``).
* :class:`PostFilterExec`       — search the global IVF index for α·k
  candidates, filter, and double α (and widen nprobe) until ≥ k valid
  results survive.

The corpus lives on the device from the engine's ``build()``.  Per call only
the (N,) bool mask and the queries cross to the device, and results come
back to the host once, at the end, so ``elapsed`` includes the device work.
All return ``SearchResult`` with global ids (-1 padded) and squared-L2
distances.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.ivf import IVFIndex
from ..kernels.ops import fused_masked_topk
from ..obs.trace import NULL_TRACER
from .predicates import AnyPredicate
from .util import next_pow2

__all__ = [
    "SearchResult",
    "PreFilterExec",
    "IndexedPreFilterExec",
    "PostFilterExec",
    "recall_at_k",
]


@dataclasses.dataclass
class SearchResult:
    dists: np.ndarray      # (B, k)
    ids: np.ndarray        # (B, k), -1 padded
    elapsed: float         # end-to-end seconds (filter + search + expansion)
    strategy: str
    n_expansions: int = 0  # post-filter α-doubling rounds
    backend: str = ""      # routed backend name ("" until packaging fills it)
    knob: str = ""         # routed knob-tier name


def recall_at_k(result_ids: np.ndarray, truth_ids: np.ndarray) -> float:
    """Mean fraction of ground-truth neighbours recovered (recall@k)."""
    b, k = truth_ids.shape
    hits = 0
    denom = 0
    for i in range(b):
        t = set(int(x) for x in truth_ids[i] if x >= 0)
        if not t:
            continue
        r = set(int(x) for x in result_ids[i] if x >= 0)
        hits += len(t & r)
        denom += len(t)
    return hits / denom if denom else 1.0


class PreFilterExec:
    """Filter -> exact masked top-k over the passing rows (100 % recall).

    The mask-to-top-k core (:meth:`search_masked`) is shared with
    :class:`IndexedPreFilterExec`; the two differ only in how the candidate
    mask is produced, so their results are identical by construction.
    """

    strategy_name = "pre"
    # Above this passing fraction, the fused masked top-k runs over the FULL
    # corpus under the mask; below it, over the passing rows gathered on the
    # device.
    FULL_SCAN_FRAC = 0.25

    def __init__(self, vectors: torch.Tensor, cat: np.ndarray, num: np.ndarray):
        """``vectors``: the (N, d) float32 corpus, already on its device."""
        self.vectors = vectors
        self.device = vectors.device
        self.cat, self.num = cat, num

    def candidate_mask(self, pred: AnyPredicate) -> np.ndarray:
        """(N,) bool predicate mask — the columnar scan."""
        return pred.eval(self.cat, self.num)

    def search(self, queries: np.ndarray, pred: AnyPredicate, k: int) -> SearchResult:
        t0 = time.perf_counter()
        mask = self.candidate_mask(pred)
        return self.search_masked(queries, mask, k, t0=t0)

    def search_masked(
        self, queries: np.ndarray, mask: np.ndarray, k: int,
        t0: Optional[float] = None, n_pass: Optional[int] = None, tracer=None,
    ) -> SearchResult:
        """Exact top-k under a precomputed candidate mask (``n_pass``: its
        passing count, when the caller has it already).

        The kernel's per-query results do not depend on the batch or on the
        row count, so neither the queries nor the gathered subset are padded
        (the reference pads both to powers of two to bound its jit shapes).
        ``tracer`` times the steps under the caller's open span: ``h2d`` (the
        queries and the mask to the device; ``bytes``), ``gather`` (the
        passing rows, gathered branch only) and ``scan`` (the launch and the
        results back on the host)."""
        if t0 is None:
            t0 = time.perf_counter()
        tr = tracer if tracer is not None else NULL_TRACER
        b = queries.shape[0]
        n = self.vectors.shape[0]
        if n_pass is None:
            n_pass = int(mask.sum())
        if n_pass == 0:
            return SearchResult(
                np.full((b, k), np.inf, np.float32),
                np.full((b, k), -1, np.int32),
                time.perf_counter() - t0,
                self.strategy_name,
            )
        with tr.span("h2d"):
            qh, mh = np.asarray(queries, np.float32), np.asarray(mask, bool)
            q = torch.as_tensor(qh, device=self.device)
            m = torch.as_tensor(mh, device=self.device)
            if tr.enabled:
                tr.annotate(bytes=qh.nbytes + mh.nbytes)
        kk = min(k, n_pass)
        # large passing set: masked fused top-k over the whole corpus, ids
        # come back global already; small: the passing rows gathered on the
        # device
        gathered = n_pass <= self.FULL_SCAN_FRAC * n
        if gathered:
            with tr.span("gather"):
                idx = torch.nonzero(m).squeeze(1)
                sub = self.vectors[idx]
        with tr.span("scan"):
            if gathered:
                d, local = fused_masked_topk(q, sub, torch.ones(n_pass, dtype=torch.bool,
                                                                device=self.device), kk)
                gids = torch.where(local >= 0, idx[local.clamp_min(0).long()], -1)
            else:
                d, gids = fused_masked_topk(q, self.vectors, m, kk)
            ids = np.full((b, k), -1, np.int32)
            dist = np.full((b, k), np.inf, np.float32)
            gids = gids.cpu().numpy()
            valid = gids >= 0
            ids[:, :kk] = np.where(valid, gids, -1)
            dist[:, :kk] = np.where(valid, d.cpu().numpy(), np.inf)
        return SearchResult(dist, ids, time.perf_counter() - t0, self.strategy_name)


class IndexedPreFilterExec(PreFilterExec):
    """Pre-filtering with the candidate mask answered by the bitmap
    attribute index instead of a columnar scan (``repro_torch.filter``).
    Predicates whose leaves reference unindexed attributes fall back to the
    scan — same answer, scan price."""

    strategy_name = "ipre"

    def __init__(self, vectors: torch.Tensor, cat: np.ndarray, num: np.ndarray,
                 index, cache):
        super().__init__(vectors, cat, num)
        self.index = index          # repro_torch.filter.AttributeIndex
        self.cache = cache          # repro_torch.filter.PredicateCache

    def candidate_mask(self, pred: AnyPredicate) -> np.ndarray:
        if self.index is not None and self.index.covers(pred):
            return self.cache.mask(pred, self.index)
        return pred.eval(self.cat, self.num)


class PostFilterExec:
    """Global-index ANN -> filter -> α-doubling expansion (paper §4.1(2))."""

    def __init__(
        self,
        index: IVFIndex,
        cat: np.ndarray,
        num: np.ndarray,
        alpha0: int = 4,
        nprobe0: int = 8,
        max_rounds: int = 8,
    ):
        self.index = index
        self.cat, self.num = cat, num
        self.alpha0, self.nprobe0, self.max_rounds = alpha0, nprobe0, max_rounds

    def initial_params(self, k: int, est_selectivity: Optional[float] = None) -> Tuple[int, int]:
        """Initial ``(candidate budget, nprobe)`` for one query, both sized
        from the estimated selectivity and rounded up to powers of two so a
        batch collapses into a handful of shared groups."""
        n, n_lists = self.index.n, self.index.n_lists
        want = self.alpha0 * k
        nprobe = self.nprobe0
        if est_selectivity is not None and est_selectivity > 0:
            want_points = self.alpha0 * k / est_selectivity
            nprobe_sel = int(np.ceil(want_points * n_lists / n))
            nprobe = int(np.clip(nprobe_sel, self.nprobe0, n_lists))
            want = max(want, int(np.ceil(want_points)))
        return min(next_pow2(want), n), min(next_pow2(nprobe), n_lists)

    def search(
        self,
        queries: np.ndarray,
        pred: AnyPredicate,
        k: int,
        est_selectivity: Optional[float] = None,
        alive: Optional[np.ndarray] = None,
    ) -> SearchResult:
        """Single-predicate entry point; delegates to the row-faithful batched
        core so the per-query and batched paths return identical ids."""
        t0 = time.perf_counter()
        q = np.asarray(queries, np.float32)
        b = q.shape[0]
        out_d, out_i, rounds = self.search_rows(q, [pred] * b, k, [est_selectivity] * b,
                                                alive=alive)
        n_exp = int(rounds.max()) if rounds.size else 0
        return SearchResult(out_d, out_i, time.perf_counter() - t0, "post", n_exp)

    def search_rows(
        self,
        q: np.ndarray,
        preds: Sequence[AnyPredicate],
        k: int,
        ests: Sequence[Optional[float]],
        alive: Optional[np.ndarray] = None,
        tracer=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Row-faithful batched post-filter search (per-row predicates).

        ``alive``, when given, is a host bool mask over the index's rows: a
        candidate whose bit is clear (tombstoned under a live corpus) is
        dropped like a predicate miss and still counts against the α budget.

        Every row runs exactly the (budget, nprobe) doubling schedule a
        dedicated ``search`` call would run; rows whose parameters coincide
        share one IVF search, and candidates are filtered with one vectorised
        predicate evaluation per distinct predicate.  Because
        ``IVFIndex.search`` is row-independent, batched results equal B
        independent calls.  ``tracer`` opens, per shared search of a
        round, an ``ivf.search`` span (``n_rows``; the index's own spans
        inside) and a ``post.check`` span over the predicate checks and the
        first-k pick.  Returns ``(dists (B, k), ids (B, k),
        expansion_rounds (B,))``."""
        tr = tracer if tracer is not None else NULL_TRACER
        # untraced, the index is called by its plain public signature:
        # the benchmark's fault checks (``bench/tests/test_bench_faults.py``)
        # put a ``search(queries, k, nprobe, mask)`` of their own in its place
        traced = {"tracer": tr} if tr.enabled else {}
        b = q.shape[0]
        n, n_lists = self.index.n, self.index.n_lists
        params = [self.initial_params(k, e) for e in ests]
        want = np.array([w for w, _ in params], np.int64)
        nprobe = np.array([p for _, p in params], np.int64)
        rounds = np.zeros(b, np.int64)
        out_d = np.full((b, k), np.inf, np.float32)
        out_i = np.full((b, k), -1, np.int32)
        # a row pays at most max_rounds IVF searches
        pending = np.arange(b) if self.max_rounds > 0 else np.empty(0, np.int64)
        while pending.size:
            groups: dict = {}
            for qi in pending:
                groups.setdefault((int(want[qi]), int(nprobe[qi])), []).append(int(qi))
            for (w, npb), rows_l in groups.items():
                rows = np.asarray(rows_l)
                with tr.span("ivf.search", n_rows=rows.size):
                    d, ids = self.index.search(q[rows], w, nprobe=npb, **traced)
                with tr.span("post.check"):
                    keep = np.zeros(ids.shape, bool)
                    bypred: dict = {}
                    for j, qi in enumerate(rows_l):
                        bypred.setdefault(preds[qi], []).append(j)
                    for p, js in bypred.items():
                        flat = ids[js].reshape(-1)
                        pos = flat >= 0
                        kp = np.zeros(flat.size, bool)
                        if pos.any():
                            kp[pos] = p.eval(self.cat[flat[pos]], self.num[flat[pos]])
                            if alive is not None:
                                kp[pos] &= alive[flat[pos]]
                        keep[js] = kp.reshape(len(js), -1)
                    # first k passing candidates per row, in distance order
                    kk = min(k, ids.shape[1])
                    order = np.argsort(~keep, axis=1, kind="stable")[:, :kk]
                    sel_i = np.take_along_axis(ids, order, axis=1)
                    sel_d = np.take_along_axis(d, order, axis=1)
                    sel_keep = np.take_along_axis(keep, order, axis=1)
                    blk_i = np.full((rows.size, k), -1, np.int32)
                    blk_d = np.full((rows.size, k), np.inf, np.float32)
                    blk_i[:, :kk] = np.where(sel_keep, sel_i, -1)
                    blk_d[:, :kk] = np.where(sel_keep, sel_d, np.inf)
                    out_i[rows] = blk_i
                    out_d[rows] = blk_d
            got = (out_i[pending] >= 0).sum(1)
            exhausted = (want[pending] >= n) & (nprobe[pending] >= n_lists)
            more = (got < k) & ~exhausted & (rounds[pending] + 1 < self.max_rounds)
            pending = pending[more]
            if pending.size:
                want[pending] = np.minimum(want[pending] * 2, n)   # paper: double α
                nprobe[pending] = np.minimum(nprobe[pending] * 2, n_lists)
                rounds[pending] += 1
        return out_d, out_i, rounds
