"""FilteredANNEngine — the public API tying the paper's pieces together.

Port of ``repro/core/engine.py``: query -> selectivity estimator -> core
planner -> selected executor -> results.  ``build()`` puts the corpus (and
the IVF index's list-sorted copy) on the device once and builds the masked
top-k kernel before any timing; ``fit()`` runs the paper's §3.1
training-data preparation; ``query`` / ``batch_query`` serve;
``ground_truth`` is the exact oracle.

``Or`` (DNF) predicates plan per disjunct: each unique conjunctive clause
gets its own decision and routing class, runs as an ordinary decision-group
row, and the clause lists merge with cross-clause de-duplication.  With
``EngineConfig.backends``, ``build()`` also builds a
:class:`~repro_torch.index.registry.BackendSet` on the engine's device,
``fit()`` races every (backend, knob-tier) class and trains the planner's
routing head, and post-filter rows the head routes run on that class.

The corpus takes writes between rebuilds (``upsert``, ``delete``): deletes
set tombstones, composed out of every candidate mask at query time, and
upserts append to a segment on the device that every query scans exactly
and merges behind the base part (``_execute_grouped``); ``compact``
folds both into a rebuilt engine whose exact plans answer bit for bit as
the live one did.  ``shard_corpus`` splits the corpus into contiguous
:class:`CorpusShard` s, each with its own executors and indexes over a view
of the device corpus (``repro_torch.serve.ShardedANNEngine`` fans out to
them).

Observability follows the reference: ``set_tracer`` installs a
:class:`~repro_torch.obs.Tracer` whose spans (``plan``,
``predicate_compile``, ``clause``, ``execute``, ``group``, ``write``,
``compact``) carry the reference's deterministic attributes, ``execute``
spans the kernel-dispatch deltas of their body; ``stats`` is the public
counter surface; ``swap_planner`` installs a refit head.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..dist.collectives import merge_topk
from ..index.flat import l2_topk
from ..index.ivf import IVFIndex
from ..index.registry import BackendSet
from ..obs.trace import NULL_TRACER
from .corpus import CompactionPolicy, LiveCorpus
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
    STRATEGY_NAMES,
    collapse_clause_results,
    default_route_name,
    expand_for_execution,
    format_plan,
)
from .planner import CorePlanner, PlannerFeatures, INDEXED_PRE, POST_FILTER, PRE_FILTER
from .predicates import AnyPredicate, Or
from .selectivity import SelEstimate, SelectivityEstimator
from .stats import DatasetStats

__all__ = ["FilteredANNEngine", "EngineConfig", "PlannedResult", "QueryResult",
           "CorpusShard", "PlanCache", "QueryLabel", "ExecutionPlan", "ClausePlan"]


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
    # registered ANN backends to race and route over (repro_torch.index
    # .registry names); None keeps the plan-only engine: no BackendSet, and
    # the decision space stays (pre, post, ipre)
    backends: Optional[Tuple[str, ...]] = None
    # recall@k a (backend, knob) class must reach on a training query before
    # utility gets a say in its routing label; below it, max-recall wins
    route_recall_target: float = 0.9
    # live-corpus compaction thresholds (core.corpus.CompactionPolicy): churn
    # past any of them makes needs_compaction()/maybe_compact() fold segment
    # + tombstones into a rebuilt index
    max_tombstone_frac: float = 0.20
    max_segment_frac: float = 0.20
    max_list_drift: float = 1.75
    device: str = DEFAULT_DEVICE       # where the corpus, indexes and planner live


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
    """Outcome of one §3.1 utility race (see :meth:`label_query`).

    ``route`` is the picked (backend, knob-tier) class when a BackendSet
    was raced, else ``NO_ROUTE``; ``route_utils`` holds every class's
    utility.  For DNF predicates ``clauses`` holds one label per unique
    conjunctive disjunct, in first-occurrence order."""

    label: int                         # PRE_FILTER or POST_FILTER
    true_sel: float
    u_pre: float
    u_post: float
    route: int = NO_ROUTE
    route_utils: Optional[np.ndarray] = None
    clauses: Optional[Tuple["QueryLabel", ...]] = None


def _kernel_snapshot() -> Tuple[dict, dict]:
    """Current (dispatch counts, dispatch wall) of the process-global kernel
    ledger: an execute span annotates the DELTA across its body, so the
    span carries exactly its own dispatches."""
    from ..kernels import ops

    return ops.dispatch_counts(), ops.dispatch_wall()


def _annotate_kernel_delta(tracer, counts0: dict, wall0: dict) -> None:
    """Attach per-kernel dispatch deltas since ``counts0``/``wall0`` to the
    open span: counts on the deterministic ledger (``kernel_<name>``
    attrs), wall seconds on the real ledger (``kernel:<name>`` wall_detail
    keys).  The ledger's wall is enqueue time on a CUDA device."""
    from ..kernels import ops

    for name, n in ops.dispatch_counts().items():
        d = n - counts0.get(name, 0)
        if d:
            tracer.annotate(**{f"kernel_{name}": d})
    for name, s in ops.dispatch_wall().items():
        dw = s - wall0.get(name, 0.0)
        if dw > 0.0:
            tracer.add_wall(f"kernel:{name}", dw)


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
    routes: Optional[np.ndarray] = None,
    backend_set: Optional[BackendSet] = None,
    live: Optional[LiveCorpus] = None,
    tracer=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decision-grouped batch execution.  The two pre-filter groups
    (scan-masked and bitmap-masked) evaluate each distinct predicate's mask
    once and run one fused masked top-k over all queries sharing it;
    un-routed post-filter rows run one row-faithful batched IVF search.
    With ``routes``/``backend_set``, post-filter rows carrying a routing
    class >= 0 group by (class, predicate): each group evaluates its mask
    once (through the bitmap index when it covers the predicate) and runs
    one ``search_class`` on the routed backend.

    Once ``live`` has mutated (the reference's ``_live_execute_grouped``),
    every base mask is cut to the base rows (the extended attribute index
    is ``n_total`` long) and ANDed with the live bitmap, and each group's
    rows also scan the append segment exactly through
    ``PreFilterExec.search_masked`` over its device rows
    (``fused_masked_topk``, the kernel on the card); the parts merge with
    ``merge_topk``, base part first, so equal distances keep handle order,
    which a fresh build over the compacted corpus reproduces (its handle ->
    position map is monotone).  Each group runs under a ``group`` span
    with the reference's attributes (``live=True`` on a mutated corpus).
    Returns ``(dists (B, k), ids (B, k), expansion_rounds (B,))``."""
    tr = tracer if tracer is not None else NULL_TRACER
    b = len(preds)
    out_d = np.full((b, k), np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    rounds = np.zeros(b, np.int64)
    if live is not None and not live.dirty:
        live = None
    alive = live.alive_mask() if live is not None else None
    seg_exec = None
    if live is not None and live.seg_n:
        seg_exec = PreFilterExec(live.seg_vectors_dev(), live.seg_cat(), live.seg_num())
    masks: dict = {}
    live_attr = {} if live is None else {"live": True}

    def base_mask(ex, pred) -> np.ndarray:
        key = (ex is pre_exec, pred)
        if key not in masks:
            m = ex.candidate_mask(pred)
            masks[key] = m if live is None else m[: live.base_n] & alive[: live.base_n]
        return masks[key]

    def finish(rows, pred, bd, bi):
        if seg_exec is not None:
            sm = seg_exec.candidate_mask(pred) & alive[live.base_n:]
            if sm.any():
                res = seg_exec.search_masked(queries[rows], sm, k)
                si = np.where(res.ids >= 0, res.ids + live.base_n, -1).astype(np.int32)
                bd, bi = merge_topk(np.stack([bd, res.dists]), np.stack([bi, si]), k)
        out_d[rows], out_i[rows] = bd, bi

    for decision, ex in ((PRE_FILTER, pre_exec), (INDEXED_PRE, ipre_exec or pre_exec)):
        groups: dict = {}
        for i in range(b):
            if decisions[i] == decision:
                groups.setdefault(preds[i], []).append(i)
        for pred, rows in groups.items():
            bk, knob = default_route_name(decision)
            with tr.span("group", decision=STRATEGY_NAMES[decision], backend=bk,
                         knob=knob, n_rows=len(rows), **live_attr):
                t0 = time.perf_counter()
                m = base_mask(ex, pred)
                res = ex.search_masked(queries[rows], m, k, t0=t0)
                if tr.enabled:
                    tr.annotate(n_candidates=int(m.sum()))
                finish(rows, pred, res.dists, res.ids)
    routed = routes is not None and backend_set is not None
    post_rows = [i for i in range(b)
                 if decisions[i] == POST_FILTER and not (routed and routes[i] >= 0)]
    if post_rows:
        with tr.span("group", decision="post", backend="ivf", knob="adapt",
                     n_rows=len(post_rows), **live_attr):
            d, ids, rnd = post_exec.search_rows(
                queries[post_rows], [preds[i] for i in post_rows], k,
                [float(ests[i]) for i in post_rows],
                alive=None if live is None else alive[: live.base_n],
            )
            rounds[post_rows] = rnd
            groups = {}
            for j, i in enumerate(post_rows):
                groups.setdefault(preds[i], []).append(j)
            for pred, js in groups.items():
                finish([post_rows[j] for j in js], pred, d[js], ids[js])
            if tr.enabled:
                tr.annotate(expansion_rounds=int(np.asarray(rnd).sum()))
    if routed:
        groups = {}
        for i in range(b):
            if decisions[i] == POST_FILTER and routes[i] >= 0:
                groups.setdefault((int(routes[i]), preds[i]), []).append(i)
        for (ci, pred), rows in groups.items():
            bk, knob = backend_set.classes()[ci]
            with tr.span("group", decision="post", backend=str(bk), knob=str(knob),
                         n_rows=len(rows), **live_attr):
                m = base_mask(ipre_exec or pre_exec, pred)
                d, ids = backend_set.search_class(ci, queries[rows], m, k)
                if tr.enabled:
                    tr.annotate(n_candidates=int(m.sum()))
                finish(rows, pred, d[:, :k], ids[:, :k])
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


@dataclasses.dataclass
class CorpusShard:
    """One contiguous partition of the corpus with its own executors.

    Made by :meth:`FilteredANNEngine.shard_corpus`.  Executors work on
    shard-local row numbers; :meth:`search_batch` maps results back to
    global ids so shard outputs merge directly.  ``vectors`` is the shard's
    host rows (a view of the engine's array), and its executors scan a view
    of the engine's device corpus.  Each shard has its OWN IVF, attribute
    index and predicate cache (bitmaps are positional), and backend set."""

    shard_id: int
    ids: np.ndarray                    # (n_local,) global row ids
    vectors: np.ndarray                # (n_local, d) host rows
    pre_exec: PreFilterExec
    post_exec: PostFilterExec
    ipre_exec: Optional[IndexedPreFilterExec] = None
    backend_set: Optional[BackendSet] = None   # per-shard backend instances
    live: Optional[LiveCorpus] = None          # created on first mutation

    def ensure_live(self) -> LiveCorpus:
        if self.live is None:
            self.live = LiveCorpus(self.vectors, self.pre_exec.cat, self.pre_exec.num,
                                   device=self.pre_exec.device)
        return self.live

    def upsert_local(self, vectors: np.ndarray, cat: np.ndarray, num: np.ndarray,
                     global_ids: np.ndarray,
                     local_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Append rows to this shard's live view and extend its local ->
        global map (``global_ids``, one per row); ``local_ids`` tombstones
        replaced local handles first.  Returns the new local handles."""
        live = self.ensure_live()
        c = np.atleast_2d(np.asarray(cat))
        m = np.atleast_2d(np.asarray(num))
        handles = live.upsert(vectors, c, m, ids=local_ids)
        if self.ipre_exec is not None and self.ipre_exec.index is not None:
            self.ipre_exec.index.extend(c, m)
            self.ipre_exec.cache.invalidate()
        self.ids = np.concatenate([self.ids, np.asarray(global_ids, self.ids.dtype)])
        return handles

    def delete_local(self, local_ids: np.ndarray) -> np.ndarray:
        """Tombstone shard-local handles; returns the newly dead ones."""
        return self.ensure_live().delete(local_ids)

    def _to_global(self, ids: np.ndarray) -> np.ndarray:
        return np.where(ids >= 0, self.ids[np.maximum(ids, 0)], -1).astype(np.int32)

    def search_batch(self, queries: np.ndarray, preds: Sequence[AnyPredicate], k: int,
                     decisions: np.ndarray, ests: np.ndarray,
                     routes: Optional[np.ndarray] = None, tracer=None,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run a planned batch on this shard through the engine's grouped
        executor (live once the shard mutated).  Returns ``(dists (B, k),
        ids (B, k) GLOBAL, expansion_rounds (B,))``."""
        d, ids, rounds = _execute_grouped(
            self.pre_exec, self.ipre_exec, self.post_exec, queries, preds, k, decisions, ests,
            routes=routes, backend_set=self.backend_set, live=self.live, tracer=tracer)
        return d, self._to_global(ids), rounds


class FilteredANNEngine:
    def __init__(
        self,
        vectors: np.ndarray,
        cat: np.ndarray,
        num: np.ndarray,
        config: EngineConfig = EngineConfig(),
    ):
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
        self.backend_set: Optional[BackendSet] = None   # built by build()
        # the live corpus: every upsert/delete goes through it, the estimator
        # composes its tombstones into the exact popcount, and
        # corpus_generation (engine-level, monotone across compactions)
        # joins the plan epoch
        self.live = LiveCorpus(self.vectors, self.cat, self.num, device=self.device)
        self.estimator.live = self.live
        self.corpus_generation = getattr(self, "corpus_generation", 0)
        self.n_compactions = getattr(self, "n_compactions", 0)
        self.compaction_policy = CompactionPolicy(
            max_tombstone_frac=self.config.max_tombstone_frac,
            max_segment_frac=self.config.max_segment_frac,
            max_list_drift=self.config.max_list_drift,
        )
        # the no-op tracer by default; an installed one survives compaction
        # rebuilds (compact() re-runs build_stats), as the trained heads do
        self.tracer = getattr(self, "tracer", NULL_TRACER)
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
        t3 = time.perf_counter()
        if self.config.backends:
            # the flat backend shares the device corpus and the ivf backend
            # the engine's IVF (same lists and seed); the others build their
            # own indexes over the corpus
            self.backend_set = BackendSet.build(
                self.vectors_dev, self.config.backends, seed=self.config.seed,
                device=self.device, ivf=self.ivf)
            self.build_time_["backends"] = time.perf_counter() - t3
        # build the kernel and run every search path once before anything
        # is timed: the §3.1 labels are wall-clock races, and a first call
        # that compiles or initialises a library would mislabel its query
        t4 = time.perf_counter()
        self._warm(self.config.default_k)
        self.build_time_.update({"upload": t1 - t0, "ivf": t2 - t1,
                                 "warmup": time.perf_counter() - t4})
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
        if self.backend_set is not None:
            for ci in range(len(self.backend_set.classes())):
                self.backend_set.search_class(ci, q, few, k)

    # ------------------------------------------------------------------
    def label_query(self, q: np.ndarray, pred: AnyPredicate, k: int = 10) -> QueryLabel:
        """Paper §3.1 utility labelling: run BOTH strategies against the
        exact masked top-k and pick the winner by U = recall@k / T_search.

        With a built BackendSet every (backend, knob-tier) class is raced
        under the same rule (mask evaluation charged to each, as routed
        execution pays it); the winner, the highest utility among classes
        whose recall meets ``config.route_recall_target`` (max-recall when
        none does), becomes the routing label, and its utility competes as
        the post side's.  DNF predicates also race every unique conjunctive
        disjunct on its own (``QueryLabel.clauses``)."""
        q = np.atleast_2d(q)
        clauses = None
        if isinstance(pred, Or):
            clauses = tuple(self.label_query(q, t, k) for t in self._unique_terms(pred))
        t_m0 = time.perf_counter()
        mask = pred.eval(self.cat, self.num)
        alive_base = self.live.alive_mask()[: self.live.base_n] if self.live.dirty else None
        if alive_base is not None:
            # race over the live rows: tombstones compose into the mask, the
            # truth and the post path alike (the segment sits out the race,
            # as both contenders would scan it alike)
            mask = mask & alive_base
        t_mask = time.perf_counter() - t_m0
        true_sel = float(mask.mean())
        ti = self.ground_truth_masked(q, mask, k)
        if alive_base is not None:
            r_pre = self.pre_exec.search_masked(q, mask, k)
            r_pre.elapsed += t_mask          # charge the mask, as search() does
        else:
            r_pre = self.pre_exec.search(q, pred, k)
        r_post = self.post_exec.search(q, pred, k, est_selectivity=true_sel,
                                       alive=alive_base)
        u_pre = recall_at_k(r_pre.ids, ti) / max(r_pre.elapsed, 1e-7)
        u_post = recall_at_k(r_post.ids, ti) / max(r_post.elapsed, 1e-7)
        route, route_utils = NO_ROUTE, None
        if self.backend_set is not None:
            n_c = len(self.backend_set.classes())
            route_utils = np.zeros(n_c, np.float64)
            recalls = np.zeros(n_c, np.float64)
            for ci in range(n_c):
                t0 = time.perf_counter()
                _, ids = self.backend_set.search_class(ci, q, mask, k)
                dt = time.perf_counter() - t0 + t_mask
                recalls[ci] = recall_at_k(ids, ti)
                route_utils[ci] = recalls[ci] / max(dt, 1e-7)
            # constrained pick: utility decides only among classes meeting
            # the recall target, so wall-clock noise cannot route to a fast
            # low-recall tier
            ok = recalls >= self.config.route_recall_target
            if ok.any():
                route = int(np.argmax(np.where(ok, route_utils, -1.0)))
            else:
                route = int(np.argmax(recalls + 1e-9 * route_utils))
            u_post = max(u_post, float(route_utils[route]))
        label = PRE_FILTER if u_pre >= u_post else POST_FILTER
        return QueryLabel(label, true_sel, u_pre, u_post, route, route_utils,
                          clauses=clauses)

    def _unique_terms(self, pred: Or) -> List[AnyPredicate]:
        """An ``Or``'s terms without repeats (by canonical key), in
        first-occurrence order: the clauses its plan and labels hold."""
        seen, out = set(), []
        for t in pred.terms:
            key = self._plan_key(t)
            if key not in seen:
                seen.add(key)
                out.append(t)
        return out

    def fit(
        self,
        train_queries: Sequence[np.ndarray],
        train_preds: Sequence[AnyPredicate],
        k: int = 10,
        verbose: bool = False,
    ) -> "FilteredANNEngine":
        """Paper §3.1: execute both strategies per training query, label by
        utility U = recall@k / T_search, train estimator GBM + planner MLP
        (and the routing head, with a BackendSet).

        The heads only decide conjunctions (an ``Or`` plans per disjunct),
        so an ``Or`` adds one training row per unique disjunct, labelled by
        that disjunct's own race.  ``labels_`` / ``route_labels_`` keep the
        rows' labels."""
        t0 = time.perf_counter()
        fit_preds, labels, true_sels, route_labels = [], [], [], []
        for q, pred in zip(train_queries, train_preds):
            lab = self.label_query(q, pred, k)
            if verbose:
                print(f"  {pred}: sel={lab.true_sel:.4f} "
                      f"U_pre={lab.u_pre:.1f} U_post={lab.u_post:.1f}")
            rows = (zip(self._unique_terms(pred), lab.clauses) if lab.clauses
                    else [(pred, lab)])
            for p, cl in rows:
                fit_preds.append(p)
                labels.append(cl.label)
                true_sels.append(cl.true_sel)
                route_labels.append(cl.route)
        self.labels_ = np.asarray(labels)
        self.route_labels_ = np.asarray(route_labels)
        self.estimator.fit(fit_preds, true_sels)
        # re-extract features with the trained estimator so train/test match
        feats = []
        for p in fit_preds:
            se = self.estimator.estimate(p)
            feats.append(self.feat.vector(p, se.sel, k, se.is_exact))
        self.planner.fit(np.stack(feats), self.labels_)
        if self.backend_set is not None:
            # routing head on the same features: picked-class labels
            self.planner.fit_routing(np.stack(feats), self.route_labels_,
                                     self.backend_set.class_names())
        # estimator AND head both changed: memoised plans are stale
        self.plan_cache.clear()
        self.planner_version += 1
        self.build_time_["fit"] = time.perf_counter() - t0
        return self

    def swap_planner(self, planner: CorePlanner) -> "FilteredANNEngine":
        """Install a refit planner head (the online feedback loop's hook).
        Memoised plans belong to the old head, so the plan cache empties."""
        self.planner = planner
        self.plan_cache.clear()
        self.planner_version += 1
        return self

    def set_tracer(self, tracer) -> "FilteredANNEngine":
        """Install a :class:`repro_torch.obs.Tracer` on every serving path
        (``None`` restores the no-op default)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        return self

    @staticmethod
    def _hit_ratio(hits: int, misses: int) -> float:
        total = hits + misses
        return round(hits / total, 6) if total else 0.0

    def stats(self) -> dict:
        """Public serving counters: predicate-cache and plan-cache stats,
        their hit ratios, the planner head version, the process-global
        kernel dispatch counts (``repro_torch.kernels.ops``, cumulative
        over every engine: diff it around the call under measurement), the
        corpus generation, the compaction count and the live corpus."""
        out: dict = {"planner_version": self.planner_version}
        ratios: dict = {}
        s = self.pred_cache.stats()
        out["pred_cache"] = s
        ratios["pred_cache"] = self._hit_ratio(s["hits"], s["misses"])
        ratios["mask_tier"] = self._hit_ratio(s["mask_hits"], s["mask_misses"])
        s = self.plan_cache.stats()
        out["plan_cache"] = s
        ratios["plan_cache"] = self._hit_ratio(s["hits"], s["misses"])
        out["cache_hit_ratio"] = ratios
        from ..kernels import ops

        out["kernel_dispatch"] = ops.dispatch_counts()
        out["corpus_generation"] = self.corpus_generation
        out["n_compactions"] = self.n_compactions
        out["live"] = self.live.stats()
        return out

    # ------------------------------------------------------------------
    # live-corpus mutations
    # ------------------------------------------------------------------
    def upsert(self, vectors: np.ndarray, cat: np.ndarray, num: np.ndarray,
               ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Stream rows into the live corpus; returns their (stable, never
        reused) handles.  ``ids`` replaces existing handles: the old rows
        are tombstoned and the new versions appended under fresh handles.

        Nothing is rebuilt: label bitmaps extend and stay exact; the range
        index goes stale (fails closed out of ``covers()``, so range
        predicates fall back to the scan and the estimated selectivity);
        statistics fold the delta in; compiled predicates are invalidated;
        the corpus generation, hence the plan epoch, moves."""
        v = np.atleast_2d(np.asarray(vectors, np.float32))
        c = np.atleast_2d(np.asarray(cat))
        m = np.atleast_2d(np.asarray(num))
        tr = self.tracer
        with tr.span("write", op="upsert", n_rows=int(v.shape[0])):
            removed_cat = removed_num = None
            if ids is not None:
                old = np.unique(np.asarray(ids, np.int64))
                old = old[~self.live.is_deleted(old)]
                if old.size:      # attrs of the rows about to be tombstoned
                    removed_cat, removed_num = self.live.row_attrs(old)
            handles = self.live.upsert(v, c, m, ids=ids)
            if self.attr_index is not None:
                self.attr_index.extend(c, m)
                self.pred_cache.invalidate()
            self.dataset_stats.apply_delta(added_cat=c, added_num=m,
                                           removed_cat=removed_cat, removed_num=removed_num)
            ivf = getattr(self, "ivf", None)
            if ivf is not None:   # keep the drift trigger's assignments current
                self.live.assign_new(ivf.centroids)
            self.corpus_generation += 1
            tr.annotate(corpus_generation=self.corpus_generation)
        return handles

    def delete(self, ids: np.ndarray) -> np.ndarray:
        """Tombstone handles (idempotent); returns the newly dead ones.  No
        index is rewritten: the tombstones compose into every candidate
        mask, backend call and exact popcount at query time."""
        tr = self.tracer
        with tr.span("write", op="delete"):
            fresh = self.live.delete(ids)
            if fresh.size:
                rc, rn = self.live.row_attrs(fresh)
                self.dataset_stats.apply_delta(removed_cat=rc, removed_num=rn)
            self.corpus_generation += 1
            tr.annotate(n_dead=int(fresh.size), corpus_generation=self.corpus_generation)
        return fresh

    def list_drift(self) -> float:
        """IVF list-balance drift if the segment were folded in: the largest
        list (base + assigned segment rows) over the build-time largest;
        1.0 when there is nothing to fold."""
        ivf = getattr(self, "ivf", None)
        if ivf is None or not self.live.seg_n:
            return 1.0
        assign = self.live.assign_new(ivf.centroids)
        counts = ivf.list_counts + np.bincount(assign, minlength=ivf.n_lists)
        return float(counts.max() / max(int(ivf.list_counts.max()), 1))

    def needs_compaction(self) -> bool:
        return self.compaction_policy.due(
            self.live.tombstone_frac, self.live.segment_frac, self.list_drift())

    def maybe_compact(self) -> Optional[np.ndarray]:
        """Compact iff churn crossed a :class:`CompactionPolicy` threshold;
        returns the handle -> new-position id_map, or None."""
        if self.live.dirty and self.needs_compaction():
            return self.compact()
        return None

    def compact(self) -> np.ndarray:
        """Fold segment + tombstones into a rebuilt engine, in place.

        Live rows land in handle order (a monotone map) and the build reruns
        over the folded arrays; the trained planner and estimator heads
        survive.  The old device corpus, IVF and backend set are dropped
        before the rebuild, so the card never holds two corpora.  Returns
        ``id_map``: old handle -> new position (-1 for dead)."""
        t0 = time.perf_counter()
        tr = self.tracer
        with tr.span("compact"):
            vectors, cat, num, id_map = self.live.compacted()
            planner, head_version = self.planner, self.planner_version
            est_model, est_gen = self.estimator.model, self.estimator.generation
            full = getattr(self, "pre_exec", None) is not None
            for name in ("vectors_dev", "ivf", "pre_exec", "ipre_exec", "post_exec", "live"):
                self.__dict__.pop(name, None)
            self.backend_set = None
            self.vectors, self.cat, self.num = vectors, cat, num
            if full:
                self.build()
            else:
                self.build_stats()  # planning-only engines stay planning-only
            self.planner = planner
            self.planner_version = head_version + 1
            self.estimator.model = est_model
            self.estimator.generation = est_gen + 1
            self.corpus_generation += 1
            self.n_compactions += 1
            tr.annotate(n_rows=int(vectors.shape[0]), n_compactions=self.n_compactions,
                        corpus_generation=self.corpus_generation)
        self.build_time_["compaction"] = time.perf_counter() - t0
        return id_map

    def mutation_state(self) -> dict:
        """Array-only snapshot of the mutable corpus state (host numpy, the
        reference's keys)."""
        return self.live.state_tree()

    def load_mutation_state(self, tree) -> "FilteredANNEngine":
        """Restore a :meth:`mutation_state` snapshot (either package's, as
        numpy arrays) onto a clean engine built over the SAME base corpus,
        by replaying it through :meth:`upsert` and :meth:`delete`."""
        base_n = int(np.asarray(tree["base_n"]))
        if base_n != self.live.base_n or self.live.dirty:
            raise ValueError("load_mutation_state needs a clean engine built over the "
                             "same base corpus")
        sv = np.asarray(tree["seg_vectors"])
        if sv.shape[0]:
            self.upsert(sv, np.asarray(tree["seg_cat"]), np.asarray(tree["seg_num"]))
        from ..filter.bitmap import expand_words

        dead = np.nonzero(expand_words(np.asarray(tree["tomb"], np.uint32),
                                       self.live.n_total))[0]
        if dead.size:
            self.delete(dead)
        return self

    # ------------------------------------------------------------------
    def _plan_epoch(self) -> Tuple[int, int, int, int]:
        """What a cached plan is valid under: the installed head, its fit
        generation, the estimator's, and the corpus generation (mutations
        change exact selectivities, hence plans)."""
        return (self.planner_version, self.planner.generation,
                self.estimator.generation, self.corpus_generation)

    def make_plan(self, pred: AnyPredicate, k: int = 10) -> Tuple[ExecutionPlan, float]:
        """Plan one predicate without executing: a single-clause plan for a
        conjunction, a per-disjunct ``"union"`` plan for an ``Or``.  Repeat
        predicates (permuted ``Or`` terms included) hit the plan cache.
        Returns ``(plan, plan_overhead_s)``."""
        t0 = time.perf_counter()
        tr = self.tracer
        with tr.span("plan", k=int(k)):
            self.plan_cache.validate_epoch(self._plan_epoch())
            key = (self._plan_key(pred), int(k))
            plan = self.plan_cache.get(key)
            hit = plan is not None
            if not hit:
                plan = self._plan_cold(pred, k)
                self.plan_cache.put(key, plan)
            tr.annotate(plan_cache="hit" if hit else "miss", decision=plan.strategy,
                        route=int(plan.route), n_clauses=plan.n_clauses)
        return plan, time.perf_counter() - t0

    def plan(self, pred: AnyPredicate, k: int = 10) -> Tuple[float, int, float]:
        """Scalar spelling of :meth:`make_plan`: ``(est_selectivity,
        decision, plan_overhead_s)``; a DNF plan's decision is its dominant
        clause's."""
        plan, overhead = self.make_plan(pred, k)
        return plan.est, plan.decision, overhead

    def plan_ex(self, pred: AnyPredicate, k: int = 10) -> Tuple[float, int, int, float]:
        """:meth:`plan` plus the routing class: ``(est_selectivity,
        decision, route, plan_overhead_s)``."""
        plan, overhead = self.make_plan(pred, k)
        return plan.est, plan.decision, plan.route, overhead

    def explain(self, pred: AnyPredicate, k: int = 10) -> str:
        plan, _ = self.make_plan(pred, k)
        return format_plan(plan, pred)

    def _routing_active(self) -> bool:
        """Routing applies only when the routing head was fitted over
        exactly this engine's (backend, knob-tier) classes; a head trained
        under another roster is ignored, not misapplied."""
        return (self.backend_set is not None
                and self.planner.route_classes == self.backend_set.class_names())

    def _route_pair(self, decision: int, route: int) -> Tuple[str, str]:
        """The (backend, knob) class a (decision, route) pair executes on:
        routed post rows name their BackendSet class, every other row the
        default class of its decision."""
        if decision == POST_FILTER and route >= 0 and self.backend_set is not None:
            return self.backend_set.classes()[route]
        return default_route_name(decision)

    def _decide_clauses(self, preds: Sequence, ests: np.ndarray,
                        exact: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """One feature matrix and one planner dispatch over conjunction
        rows: per-row ``(decisions, routes)``.  Untrained, the selectivity
        threshold picks pre vs post and coverage upgrades pre to the indexed
        variant."""
        fm = self.feat.matrix(list(preds), ests, k, exact)
        if self.planner.params is not None:
            decisions = self.planner.decide(fm).astype(np.int32)
        else:
            decisions = np.where(ests < 0.05, PRE_FILTER, POST_FILTER)
            decisions = np.where((decisions == PRE_FILTER) & exact, INDEXED_PRE,
                                 decisions).astype(np.int32)
        routes = np.full(len(preds), NO_ROUTE, np.int32)
        if self._routing_active():
            r = self.planner.route(fm)
            if r is not None:
                routes = np.where(decisions == POST_FILTER, r, NO_ROUTE).astype(np.int32)
        return decisions, routes

    def _clause_plan(self, pred, est: float, exact: bool, decision: int,
                     route: int) -> ClausePlan:
        bk, knob = self._route_pair(decision, route)
        return ClausePlan(self._plan_key(pred), int(decision), bk, knob,
                          float(est), int(route), bool(exact))

    def _plan_rows(self, preds: Sequence[AnyPredicate],
                   ses: Sequence[SelEstimate], k: int) -> List[ExecutionPlan]:
        """Plans for predicates with their estimates: every conjunction and
        every unique clause of every ``Or`` pooled into one head dispatch."""
        rows, owner = [], []                      # (pred, est, exact), plan slot
        for j, (p, se) in enumerate(zip(preds, ses)):
            if isinstance(p, Or):
                seen = set()
                for t, ce in zip(p.terms, se.per_clause):
                    key = self._plan_key(t)
                    if key not in seen:
                        seen.add(key)
                        rows.append((t, ce.sel, ce.is_exact))
                        owner.append(j)
            else:
                rows.append((p, se.sel, se.is_exact))
                owner.append(j)
        decisions = routes = np.zeros(0, np.int32)
        if rows:
            decisions, routes = self._decide_clauses(
                [r[0] for r in rows], np.asarray([r[1] for r in rows], np.float64),
                np.asarray([r[2] for r in rows], bool), k)
        clauses: List[List[ClausePlan]] = [[] for _ in preds]
        for r, j in enumerate(owner):
            clauses[j].append(self._clause_plan(*rows[r], int(decisions[r]), int(routes[r])))
        plans = []
        for p, se, cl in zip(preds, ses, clauses):
            if not isinstance(p, Or):
                plans.append(ExecutionPlan(tuple(cl), float(se.sel), bool(se.is_exact)))
            elif cl:
                plans.append(ExecutionPlan(tuple(cl), float(se.sel), bool(se.is_exact), "union"))
            else:                               # an empty Or matches nothing
                plans.append(ExecutionPlan((), 0.0, True, "union"))
        return plans

    def _n_words(self) -> int:
        return (self.vectors.shape[0] + 31) // 32

    def _plan_cold(self, pred: AnyPredicate, k: int) -> ExecutionPlan:
        """Estimate (under a ``predicate_compile`` span) and plan one
        predicate; an ``Or`` opens one ``clause`` span per unique disjunct."""
        tr = self.tracer
        with tr.span("predicate_compile"):
            m0 = self.pred_cache.misses
            se = self.estimator.estimate(pred)
            if tr.enabled:
                miss = self.pred_cache.misses - m0
                tr.annotate(estimator="exact" if se.is_exact else "gbm",
                            pred_cache="miss" if miss else "hit",
                            bitmap_words=miss * self._n_words())
        plan = self._plan_rows([pred], [se], k)[0]
        if tr.enabled and isinstance(pred, Or):
            for j, c in enumerate(plan.clauses):
                with tr.span("clause", index=j, decision=STRATEGY_NAMES[c.decision],
                             backend=c.backend, knob=c.knob, route=c.route):
                    tr.annotate(est=round(c.est, 6), exact=c.sel_exact)
        return plan

    def make_plan_batch(
        self, preds: Sequence[AnyPredicate], k: int = 10
    ) -> Tuple[List[ExecutionPlan], float]:
        """Batched :meth:`make_plan`: one selectivity pass and ONE planner
        dispatch over the plan-cache misses' conjunctions and DNF clauses.
        Returns ``(plans, overhead)``."""
        t0 = time.perf_counter()
        tr = self.tracer
        b = len(preds)
        with tr.span("plan", n_preds=b, k=int(k)):
            self.plan_cache.validate_epoch(self._plan_epoch())
            plans: List[Optional[ExecutionPlan]] = [None] * b
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
                with tr.span("predicate_compile", n_preds=len(miss)):
                    m0 = self.pred_cache.misses
                    ses = self.estimator.estimate_batch(sub)
                    if tr.enabled:
                        n_ex = int(sum(se.is_exact for se in ses))
                        md = self.pred_cache.misses - m0
                        tr.annotate(estimator_exact=n_ex, estimator_gbm=len(miss) - n_ex,
                                    pred_cache_misses=md, bitmap_words=md * self._n_words())
                for i, plan in zip(miss, self._plan_rows(sub, ses, k)):
                    plans[i] = plan
                    self.plan_cache.put(keys[i], plan)
                n_dnf = sum(isinstance(p, Or) for p in sub)
                if tr.enabled and n_dnf:
                    tr.annotate(n_dnf=n_dnf)
            tr.annotate(plan_cache_hits=b - len(miss), plan_cache_misses=len(miss))
        return plans, time.perf_counter() - t0

    def plan_batch(self, preds: Sequence[AnyPredicate], k: int = 10,
                   ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Scalar spelling of :meth:`make_plan_batch`: ``(est_selectivities
        (B,), decisions (B,), plan_overhead_s)``."""
        plans, overhead = self.make_plan_batch(preds, k)
        return (np.asarray([p.est for p in plans], np.float64),
                np.asarray([p.decision for p in plans], np.int32), overhead)

    def plan_batch_ex(self, preds: Sequence[AnyPredicate], k: int = 10,
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
        """Batched :meth:`plan_ex`: also the per-row routing classes
        (``NO_ROUTE`` for non-post rows or with routing off)."""
        plans, overhead = self.make_plan_batch(preds, k)
        return (np.asarray([p.est for p in plans], np.float64),
                np.asarray([p.decision for p in plans], np.int32),
                np.asarray([p.route for p in plans], np.int32), overhead)

    def shard_corpus(self, n_shards: int, n_lists: Optional[int] = None) -> List[CorpusShard]:
        """Partition the corpus into ``n_shards`` contiguous shards, each
        with its own pre-filter executors, attribute index, post-filter IVF
        (seeded ``seed + s``) and backend set.  A shard's device rows are a
        view of the engine's device corpus, not a copy.  Per-shard IVF lists
        default to sqrt(n_local), clamped to the shard's row count; empty
        shards are dropped."""
        assert n_shards >= 1
        from ..filter import AttributeIndex, PredicateCache

        corpus = getattr(self, "vectors_dev", None)
        if corpus is None:            # a planning-only engine: upload once
            corpus = self.vectors_dev = torch.as_tensor(self.vectors, device=self.device)
        shards = []
        for s, ids in enumerate(np.array_split(np.arange(self.vectors.shape[0]), n_shards)):
            if ids.size == 0:
                continue
            lo, hi = int(ids[0]), int(ids[-1]) + 1
            v = corpus[lo:hi]
            c, m = self.cat[lo:hi], self.num[lo:hi]
            lists = min(n_lists or max(1, int(np.sqrt(ids.size))), ids.size)
            ivf = IVFIndex(v, lists, seed=self.config.seed + s, device=self.device).build()
            ipre = None
            if self.config.attr_index:
                ipre = IndexedPreFilterExec(
                    v, c, m, AttributeIndex.build(c, m, self.config.range_buckets),
                    PredicateCache(self.config.pred_cache_size))
            bset = None
            if self.config.backends:
                bset = BackendSet.build(v, self.config.backends, seed=self.config.seed + s,
                                        device=self.device, ivf=ivf)
            shards.append(CorpusShard(
                shard_id=s, ids=ids, vectors=self.vectors[lo:hi],
                pre_exec=PreFilterExec(v, c, m),
                post_exec=PostFilterExec(ivf, c, m, alpha0=self.config.alpha0,
                                         nprobe0=self.config.nprobe0),
                ipre_exec=ipre, backend_set=bset,
            ))
        return shards

    # ------------------------------------------------------------------
    def query(self, q: np.ndarray, pred: AnyPredicate, k: int = 10) -> PlannedResult:
        """Plan + execute one filtered ANN query."""
        q = np.atleast_2d(q)
        plan, plan_overhead = self.make_plan(pred, k)
        if plan.is_dnf or self.live.dirty:
            # a union, or a mutated corpus: the grouped (live) executor
            return self._query_grouped(q, pred, k, plan, plan_overhead)
        decision, route = plan.decision, plan.route
        tr = self.tracer
        with tr.span("execute", n_queries=1, k=int(k), live=False,
                     decision=STRATEGY_NAMES[decision]):
            kc0, kw0 = _kernel_snapshot() if tr.enabled else ({}, {})
            if decision == INDEXED_PRE:
                res = self.ipre_exec.search(q, pred, k)
            elif decision == PRE_FILTER:
                res = self.pre_exec.search(q, pred, k)
            elif route >= 0 and self.backend_set is not None:
                # routed: mask once (bitmap-indexed when covered), then the
                # chosen backend's masked search at the chosen knob tier
                t0 = time.perf_counter()
                mask = self.ipre_exec.candidate_mask(pred)
                d, ids = self.backend_set.search_class(route, q, mask, k)
                res = SearchResult(d, ids, time.perf_counter() - t0, "post")
            else:
                # the estimate also *parameterises* the post-filter executor
                res = self.post_exec.search(q, pred, k, est_selectivity=plan.est)
            if tr.enabled:
                _annotate_kernel_delta(tr, kc0, kw0)
        res.backend, res.knob = plan.backend, plan.knob
        res.elapsed += plan_overhead   # end-to-end includes planning (paper §4.1)
        return PlannedResult(res, plan, plan_overhead)

    def _execute(self, queries: np.ndarray, preds: Sequence[AnyPredicate], k: int,
                 plans: Sequence[ExecutionPlan], span: dict):
        """Run planned rows as clause rows through the grouped executor and
        collapse DNF rows back, under one ``execute`` span (attributes
        ``span`` plus the kernel-dispatch deltas): ``(dists, ids, rounds)``, one row
        each."""
        exp_rows, exp_preds, decisions, ests, routes, row_map = (
            expand_for_execution(preds, plans))
        # no DNF row: the expansion is the identity
        identity = len(exp_preds) == len(preds) and all(len(m) == 1 for m in row_map)
        tr = self.tracer
        with tr.span("execute", **span):
            kc0, kw0 = _kernel_snapshot() if tr.enabled else ({}, {})
            d, ids, rounds = _execute_grouped(
                self.pre_exec, self.ipre_exec, self.post_exec,
                queries if identity else queries[exp_rows], exp_preds, k, decisions, ests,
                routes=routes, backend_set=self.backend_set, live=self.live, tracer=tr,
            )
            out = collapse_clause_results(d, ids, rounds, row_map, k)
            if tr.enabled:
                _annotate_kernel_delta(tr, kc0, kw0)
        return out

    def _query_grouped(self, q: np.ndarray, pred: AnyPredicate, k: int,
                       plan: ExecutionPlan, plan_overhead: float) -> PlannedResult:
        """One query through the grouped executor: a DNF query's clauses as
        decision-group rows merged with cross-clause de-duplication, or any
        query once the corpus mutated."""
        t0 = time.perf_counter()
        span = dict(n_queries=1, k=int(k), live=self.live.dirty)
        if plan.is_dnf:
            span.update(decision="dnf", n_clauses=plan.n_clauses)
        d, ids, rounds = self._execute(q, [pred], k, [plan], span)
        share = time.perf_counter() - t0 + plan_overhead
        return package_results(d, ids, rounds, [plan], share, plan_overhead)[0]

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
        t0 = time.perf_counter()
        d, ids, rounds = self._execute(queries, preds, k, plans,
                                       dict(n_queries=b, k=int(k), live=self.live.dirty))
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
        """Exact top-k ids of ``pred``'s rows; on a mutated corpus, of its
        LIVE rows, through the pre-filter path of ``_execute_grouped``: the
        base rows and the segment each scanned with ``fused_masked_topk``
        and merged base part first.  That scan's (query, row) distance does
        not depend on how many rows it scans, so an upserted copy of a base
        row ties the row exactly and the lower handle wins, as in serving
        and after compaction."""
        if not self.live.dirty:
            return self.ground_truth_masked(q, pred.eval(self.cat, self.num), k)
        q = np.atleast_2d(np.asarray(q, np.float32))
        b = q.shape[0]
        _, ids, _ = _execute_grouped(self.pre_exec, None, self.post_exec, q, [pred] * b, k,
                                     np.full(b, PRE_FILTER), np.zeros(b), live=self.live)
        return ids
