"""FilteredANNEngine — the public API tying the paper's pieces together.

Port of ``repro/core/engine.py``, cut to the main path: query ->
selectivity estimator -> core planner -> selected executor -> results.
``build()`` puts the corpus (and the IVF index's list-sorted copy) on the
device once and builds the masked top-k kernel before any timing;
``fit()`` runs the paper's §3.1 training-data preparation; ``query`` /
``batch_query`` serve; ``ground_truth`` is the exact oracle.

Not in this slice, each raising ``NotImplementedError`` rather than
answering wrongly: ``Or`` (DNF) predicates, ``EngineConfig.backends``
(the backend registry and routing head) and the live-corpus mutations.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..index.flat import l2_topk
from ..index.ivf import IVFIndex
from .executors import (
    IndexedPreFilterExec,
    PostFilterExec,
    PreFilterExec,
    SearchResult,
    recall_at_k,
)
from .plan import (
    ClausePlan,
    ExecutionPlan,
    NO_ROUTE,
    default_route_name,
    format_plan,
)
from .planner import CorePlanner, PlannerFeatures, INDEXED_PRE, POST_FILTER, PRE_FILTER
from .predicates import AnyPredicate, Or
from .selectivity import SelectivityEstimator
from .stats import DatasetStats

__all__ = ["FilteredANNEngine", "EngineConfig", "PlannedResult", "QueryResult",
           "PlanCache", "QueryLabel", "ExecutionPlan", "ClausePlan"]


@dataclasses.dataclass
class EngineConfig:
    n_lists: Optional[int] = None      # IVF lists (default sqrt(N))
    sample_frac: float = 0.02          # stats sample (paper: 1-5 %)
    alpha0: int = 4                    # initial post-filter expansion
    nprobe0: int = 8
    seed: int = 0
    default_k: int = 10                # k the build warms the search paths with
    attr_index: bool = True            # build the bitmap/range attribute index
    range_buckets: int = 128           # filter.ranges.DEFAULT_BUCKETS
    pred_cache_size: int = 256         # compiled-predicate LRU entries
    plan_cache_size: int = 1024        # memoised (predicate, k) plan entries
    # registered ANN backends: the registry is not ported yet, so only None
    # (the plan-only engine) is accepted
    backends: Optional[Tuple[str, ...]] = None
    device: str = DEFAULT_DEVICE       # where the corpus, index and planner live


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


@dataclasses.dataclass
class PlannedResult:
    """One served query: the executed :class:`SearchResult` plus the
    :class:`ExecutionPlan` it ran under."""

    result: SearchResult
    plan: ExecutionPlan
    plan_overhead: float               # seconds spent estimating + deciding

    @property
    def est_selectivity(self) -> float:
        return self.plan.est

    @property
    def decision(self) -> int:
        return self.plan.decision


#: public alias — "the thing a query returns"
QueryResult = PlannedResult


@dataclasses.dataclass
class QueryLabel:
    """Outcome of one §3.1 utility race (see :meth:`label_query`)."""

    label: int                         # PRE_FILTER or POST_FILTER
    true_sel: float
    u_pre: float
    u_post: float
    route: int = NO_ROUTE
    route_utils: Optional[np.ndarray] = None


def package_results(
    d: np.ndarray,
    ids: np.ndarray,
    rounds: np.ndarray,
    plans: Sequence[ExecutionPlan],
    share: float,
    plan_share: float,
) -> List[PlannedResult]:
    """Wrap batched (B, k) arrays into per-row PlannedResults (``share`` is
    the batch wall time split evenly across rows, plan overhead included)."""
    return [
        PlannedResult(
            SearchResult(d[j : j + 1], ids[j : j + 1], share, plan.strategy,
                         n_expansions=int(rounds[j]),
                         backend=plan.backend, knob=plan.knob),
            plan, plan_share,
        )
        for j, plan in enumerate(plans)
    ]


def _execute_grouped(
    pre_exec: PreFilterExec,
    ipre_exec: Optional[IndexedPreFilterExec],
    post_exec: PostFilterExec,
    queries: np.ndarray,
    preds: Sequence[AnyPredicate],
    k: int,
    decisions: np.ndarray,
    ests: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decision-grouped batch execution.  The two pre-filter groups
    (scan-masked and bitmap-masked) evaluate each distinct predicate's mask
    once and run one fused masked top-k over all queries sharing it; the
    post-filter rows run one row-faithful batched IVF search.  Returns
    ``(dists (B, k), ids (B, k), expansion_rounds (B,))``."""
    b = len(preds)
    out_d = np.full((b, k), np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    rounds = np.zeros(b, np.int64)
    for decision, ex in ((PRE_FILTER, pre_exec), (INDEXED_PRE, ipre_exec or pre_exec)):
        groups: dict = {}
        for i in range(b):
            if decisions[i] == decision:
                groups.setdefault(preds[i], []).append(i)
        for pred, rows in groups.items():
            res = ex.search(queries[rows], pred, k)
            out_d[rows], out_i[rows] = res.dists, res.ids
    post_rows = [i for i in range(b) if decisions[i] == POST_FILTER]
    if post_rows:
        d, ids, rnd = post_exec.search_rows(
            queries[post_rows], [preds[i] for i in post_rows], k,
            [float(ests[i]) for i in post_rows],
        )
        out_d[post_rows], out_i[post_rows] = d, ids
        rounds[post_rows] = rnd
    return out_d, out_i, rounds


class PlanCache:
    """LRU memo of ``(canonical predicate key, k) -> ExecutionPlan``,
    emptied whenever the (planner head, estimator) epoch it was filled
    under changes (:meth:`validate_epoch`)."""

    def __init__(self, capacity: int = 1024):
        assert capacity >= 1
        self.capacity = capacity
        self._store: "OrderedDict[Tuple, ExecutionPlan]" = OrderedDict()
        self.epoch: Tuple = ()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def validate_epoch(self, epoch: Tuple) -> None:
        if epoch != self.epoch:
            if self.epoch:
                self.invalidations += 1
            self._store.clear()
            self.epoch = epoch

    def __len__(self) -> int:
        return len(self._store)

    def get(self, key) -> Optional[ExecutionPlan]:
        hit = self._store.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        self._store.move_to_end(key)
        return hit

    def put(self, key, value: ExecutionPlan) -> None:
        self._store[key] = value
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._store.clear()

    def stats(self) -> Dict[str, int]:
        return {
            "size": len(self._store), "capacity": self.capacity,
            "hits": self.hits, "misses": self.misses, "evictions": self.evictions,
            "invalidations": self.invalidations,
        }


class FilteredANNEngine:
    def __init__(
        self,
        vectors: np.ndarray,
        cat: np.ndarray,
        num: np.ndarray,
        config: EngineConfig = EngineConfig(),
    ):
        if config.backends:
            raise _not_in_slice("EngineConfig.backends (the backend registry)")
        self.device = resolve_device(config.device)
        self.vectors = np.ascontiguousarray(vectors, np.float32)
        self.cat, self.num = cat, num
        self.config = config
        self.build_time_: dict = {}

    # ------------------------------------------------------------------
    def build_stats(self) -> "FilteredANNEngine":
        """Planning-only build: statistics, attribute index, estimator,
        planner and features (host numpy, apart from the planner head)."""
        t0 = time.perf_counter()
        self.dataset_stats = DatasetStats.build(
            self.vectors, self.cat, self.num,
            sample_frac=self.config.sample_frac, seed=self.config.seed,
        )
        t1 = time.perf_counter()
        from ..filter import AttributeIndex, PredicateCache
        from ..filter.cache import canonical_key

        self.attr_index = (
            AttributeIndex.build(self.cat, self.num, self.config.range_buckets)
            if self.config.attr_index else None
        )
        self.pred_cache = PredicateCache(self.config.pred_cache_size)
        self.plan_cache = PlanCache(self.config.plan_cache_size)
        self._plan_key = canonical_key
        self.planner_version = 0
        t2 = time.perf_counter()
        self.estimator = SelectivityEstimator(
            self.dataset_stats, index=self.attr_index, cache=self.pred_cache
        )
        self.planner = CorePlanner(seed=self.config.seed, device=self.device)
        self.feat = PlannerFeatures(self.dataset_stats)
        self.build_time_["stats"] = t1 - t0
        self.build_time_["attr_index"] = t2 - t1
        return self

    def build(self) -> "FilteredANNEngine":
        """Offline phase: statistics, the corpus on the device, the global
        IVF index, the executors, and one launch of every search path."""
        self.build_stats()
        t0 = time.perf_counter()
        self.vectors_dev = torch.as_tensor(self.vectors, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.ivf = IVFIndex(self.vectors_dev, self.config.n_lists,
                            seed=self.config.seed, device=self.device).build()
        t2 = time.perf_counter()
        self.pre_exec = PreFilterExec(self.vectors_dev, self.cat, self.num)
        self.ipre_exec = IndexedPreFilterExec(
            self.vectors_dev, self.cat, self.num, self.attr_index, self.pred_cache
        )
        self.post_exec = PostFilterExec(
            self.ivf, self.cat, self.num,
            alpha0=self.config.alpha0, nprobe0=self.config.nprobe0,
        )
        # build the kernel and run every search path once before anything
        # is timed: the §3.1 labels are wall-clock races, and a first call
        # that compiles or initialises a library would mislabel its query
        self._warm(self.config.default_k)
        t3 = time.perf_counter()
        self.build_time_.update({"upload": t1 - t0, "ivf": t2 - t1, "warmup": t3 - t2})
        return self

    def _warm(self, k: int) -> None:
        n, d = self.vectors.shape
        q = np.zeros((1, d), np.float32)
        full = np.ones(n, bool)
        few = np.zeros(n, bool)
        few[: max(1, min(n // 8, 1 << 16))] = True
        self.pre_exec.search_masked(q, full, k)         # full-corpus kernel
        self.pre_exec.search_masked(q, few, k)          # gathered-subset kernel
        self.ivf.search(q, k)
        self.ground_truth_masked(q, full, k)

    # ------------------------------------------------------------------
    def label_query(self, q: np.ndarray, pred: AnyPredicate, k: int = 10) -> QueryLabel:
        """Paper §3.1 utility labelling: run BOTH strategies against the
        exact masked top-k and pick the winner by U = recall@k / T_search."""
        if isinstance(pred, Or):
            raise _not_in_slice("DNF (Or) planning")
        q = np.atleast_2d(q)
        mask = pred.eval(self.cat, self.num)
        true_sel = float(mask.mean())
        ti = self.ground_truth_masked(q, mask, k)
        r_pre = self.pre_exec.search(q, pred, k)
        r_post = self.post_exec.search(q, pred, k, est_selectivity=true_sel)
        u_pre = recall_at_k(r_pre.ids, ti) / max(r_pre.elapsed, 1e-7)
        u_post = recall_at_k(r_post.ids, ti) / max(r_post.elapsed, 1e-7)
        label = PRE_FILTER if u_pre >= u_post else POST_FILTER
        return QueryLabel(label, true_sel, u_pre, u_post)

    def fit(
        self,
        train_queries: Sequence[np.ndarray],
        train_preds: Sequence[AnyPredicate],
        k: int = 10,
        verbose: bool = False,
    ) -> "FilteredANNEngine":
        """Paper §3.1: execute both strategies per training query, label by
        utility U = recall@k / T_search, train estimator GBM + planner MLP."""
        t0 = time.perf_counter()
        labels, true_sels = [], []
        for q, pred in zip(train_queries, train_preds):
            lab = self.label_query(q, pred, k)
            if verbose:
                print(f"  {pred}: sel={lab.true_sel:.4f} "
                      f"U_pre={lab.u_pre:.1f} U_post={lab.u_post:.1f}")
            labels.append(lab.label)
            true_sels.append(lab.true_sel)
        self.labels_ = np.asarray(labels)
        self.estimator.fit(list(train_preds), true_sels)
        # re-extract features with the trained estimator so train/test match
        feats = []
        for p in train_preds:
            se = self.estimator.estimate(p)
            feats.append(self.feat.vector(p, se.sel, k, se.is_exact))
        self.planner.fit(np.stack(feats), self.labels_)
        # estimator AND head both changed: memoised plans are stale
        self.plan_cache.clear()
        self.planner_version += 1
        self.build_time_["fit"] = time.perf_counter() - t0
        return self

    # ------------------------------------------------------------------
    # live-corpus mutations: not in this slice
    # ------------------------------------------------------------------
    def upsert(self, vectors, cat, num, ids=None):
        raise _not_in_slice("the live corpus (upsert)")

    def delete(self, ids):
        raise _not_in_slice("the live corpus (delete)")

    def compact(self):
        raise _not_in_slice("the live corpus (compact)")

    # ------------------------------------------------------------------
    def _plan_epoch(self) -> Tuple[int, int, int]:
        return (self.planner_version, self.planner.generation,
                self.estimator.generation)

    def make_plan(self, pred: AnyPredicate, k: int = 10) -> Tuple[ExecutionPlan, float]:
        """Plan one predicate without executing; repeat predicates hit the
        plan cache.  Returns ``(plan, plan_overhead_s)``."""
        if isinstance(pred, Or):
            raise _not_in_slice("DNF (Or) planning")
        t0 = time.perf_counter()
        self.plan_cache.validate_epoch(self._plan_epoch())
        key = (self._plan_key(pred), int(k))
        plan = self.plan_cache.get(key)
        if plan is None:
            plan = self._plan_cold(pred, k)
            self.plan_cache.put(key, plan)
        return plan, time.perf_counter() - t0

    def explain(self, pred: AnyPredicate, k: int = 10) -> str:
        plan, _ = self.make_plan(pred, k)
        return format_plan(plan, pred)

    def _fallback_decisions(self, ests: np.ndarray, exact: np.ndarray) -> np.ndarray:
        """Untrained planner: the selectivity threshold picks pre vs post,
        coverage upgrades pre to the indexed variant."""
        d = np.where(ests < 0.05, PRE_FILTER, POST_FILTER)
        return np.where((d == PRE_FILTER) & exact, INDEXED_PRE, d).astype(np.int32)

    def _single_plan(self, pred, est: float, exact: bool, decision: int) -> ExecutionPlan:
        bk, knob = default_route_name(decision)
        cl = ClausePlan(self._plan_key(pred), int(decision), bk, knob,
                        float(est), NO_ROUTE, bool(exact))
        return ExecutionPlan((cl,), float(est), bool(exact), "none")

    def _plan_cold(self, pred: AnyPredicate, k: int) -> ExecutionPlan:
        se = self.estimator.estimate(pred)
        if self.planner.params is not None:
            fv = self.feat.vector(pred, se.sel, k, se.is_exact)
            decision = int(self.planner.decide(fv)[0])
        else:
            decision = int(self._fallback_decisions(
                np.asarray([se.sel]), np.asarray([se.is_exact]))[0])
        return self._single_plan(pred, se.sel, se.is_exact, decision)

    def make_plan_batch(
        self, preds: Sequence[AnyPredicate], k: int = 10
    ) -> Tuple[List[ExecutionPlan], float]:
        """Batched :meth:`make_plan`: one selectivity pass and ONE planner
        dispatch over the plan-cache misses.  Returns ``(plans, overhead)``."""
        if any(isinstance(p, Or) for p in preds):
            raise _not_in_slice("DNF (Or) planning")
        t0 = time.perf_counter()
        self.plan_cache.validate_epoch(self._plan_epoch())
        plans: List[Optional[ExecutionPlan]] = [None] * len(preds)
        keys = [(self._plan_key(p), int(k)) for p in preds]
        miss = []
        for i, key in enumerate(keys):
            hit = self.plan_cache.get(key)
            if hit is None:
                miss.append(i)
            else:
                plans[i] = hit
        if miss:
            sub = [preds[i] for i in miss]
            ses = self.estimator.estimate_batch(sub)
            ests = np.asarray([s.sel for s in ses], np.float64)
            exact = np.asarray([s.is_exact for s in ses], bool)
            if self.planner.params is not None:
                decisions = self.planner.decide(
                    self.feat.matrix(sub, ests, k, exact)).astype(np.int32)
            else:
                decisions = self._fallback_decisions(ests, exact)
            for j, i in enumerate(miss):
                plans[i] = self._single_plan(sub[j], ests[j], exact[j], int(decisions[j]))
                self.plan_cache.put(keys[i], plans[i])
        return plans, time.perf_counter() - t0

    # ------------------------------------------------------------------
    def query(self, q: np.ndarray, pred: AnyPredicate, k: int = 10) -> PlannedResult:
        """Plan + execute one filtered ANN query."""
        q = np.atleast_2d(q)
        plan, plan_overhead = self.make_plan(pred, k)
        decision = plan.decision
        if decision == INDEXED_PRE:
            res = self.ipre_exec.search(q, pred, k)
        elif decision == PRE_FILTER:
            res = self.pre_exec.search(q, pred, k)
        else:
            # the estimate also *parameterises* the post-filter executor
            res = self.post_exec.search(q, pred, k, est_selectivity=plan.est)
        res.backend, res.knob = plan.backend, plan.knob
        res.elapsed += plan_overhead   # end-to-end includes planning (paper §4.1)
        return PlannedResult(res, plan, plan_overhead)

    def batch_query(
        self, queries: np.ndarray, preds: Sequence[AnyPredicate], k: int = 10
    ) -> List[PlannedResult]:
        """Batched plan -> group-by-decision -> execute.  Results equal B
        independent :meth:`query` calls; per-result ``elapsed`` is the batch
        wall time split evenly across rows."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        b = len(preds)
        plans, plan_overhead = self.make_plan_batch(preds, k)
        plan_share = plan_overhead / max(b, 1)
        decisions = np.asarray([p.decision for p in plans], np.int32)
        ests = np.asarray([p.est for p in plans], np.float64)
        t0 = time.perf_counter()
        d, ids, rounds = _execute_grouped(
            self.pre_exec, self.ipre_exec, self.post_exec,
            queries, preds, k, decisions, ests,
        )
        share = (time.perf_counter() - t0) / max(b, 1) + plan_share
        return package_results(d, ids, rounds, plans, share, plan_share)

    # ------------------------------------------------------------------
    def ground_truth_masked(self, q: np.ndarray, mask: np.ndarray, k: int = 10) -> np.ndarray:
        """Exact top-k ids under a host (N,) bool mask, on the device."""
        qt = torch.as_tensor(np.atleast_2d(np.asarray(q, np.float32)), device=self.device)
        mt = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        _, ti = l2_topk(qt, self.vectors_dev, k, mt)
        return ti.cpu().numpy()

    def ground_truth(self, q: np.ndarray, pred: AnyPredicate, k: int = 10) -> np.ndarray:
        return self.ground_truth_masked(q, pred.eval(self.cat, self.num), k)
