"""Online planner feedback: log sampled outcomes, refit, guard, swap.

Port of ``repro/runtime/feedback.py``.  Sampling, the log, the holdout
permutation and the guard are the reference's; a candidate head is drawn
from a torch generator (``CorePlanner``), so its weights differ from the
reference's for the same seed, and the two packages agree on the guard's
decision only when they judge the same candidate state
(:meth:`OnlineFeedback._fit_candidate` makes it).

Closes the paper's learning loop from offline fit to online adaptation:
the offline planner (§3.1) is trained once on a synthetic workload, but
plan win-rates shift with the live query distribution — so the runtime
samples a fraction of served traffic, shadow-executes BOTH strategies to
get a ground-truth win label (same utility labelling as
``FilteredANNEngine.fit``: U = recall@k / T_search against the exact
masked top-k), and periodically refits a candidate ``CorePlanner`` from
the accumulated log.

The **drift guard** makes the swap safe: the log is split into a train
slice and a holdout, the candidate trains on the slice, and it only
replaces the serving head if its holdout ROC-AUC does not regress the
current head's AUC on the same holdout (``auc_slack`` tolerance).  A
refit gone wrong — too few examples, degenerate labels, noisy timings —
keeps the old head and tries again later.

The labeller is pluggable (``labeler=``) so tests can drive the loop with
a deterministic oracle; the default shadow labeller measures real wall
time, which is the one intentionally nondeterministic input in the
runtime (virtual-time scheduling and result ids stay replayable — the
replay tests run with feedback disabled).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from ..core.engine import FilteredANNEngine, PlannedResult, QueryLabel, NO_ROUTE
from ..core.planner import CorePlanner, roc_auc
from ..core.predicates import Or
from .queue import RuntimeRequest

__all__ = ["FeedbackConfig", "LogEntry", "OnlineFeedback"]


@dataclasses.dataclass
class FeedbackConfig:
    sample_rate: float = 0.1    # fraction of traffic shadow-labelled
    refit_every: int = 64       # new sampled examples between refit attempts
    min_examples: int = 32      # never refit on less than this
    holdout_frac: float = 0.25  # drift-guard holdout share of the log
    auc_slack: float = 0.0      # candidate may be at most this much worse
    max_log: int = 4096         # sliding window: oldest entries age out
    seed: int = 0


@dataclasses.dataclass
class LogEntry:
    """One sampled observation: what the paper's §3.1 labeller produces,
    collected online instead of from a synthetic workload."""

    features: np.ndarray        # planner feature vector at observe time
    decision: int               # what the serving planner chose
    label: int                  # ground-truth winner (PRE_FILTER/POST_FILTER)
    latency: float              # latency the SERVED strategy actually paid (s)
    route: int = NO_ROUTE       # best (backend, knob) class when routing is on


class OnlineFeedback:
    """Sampled observe -> log -> guarded refit loop around an engine.

    ``engine`` must be a fully ``build()``-and-ideally-``fit()`` flat
    :class:`FilteredANNEngine` (shadow labelling runs its pre/post
    executors; for a sharded deployment pass ``sharded.engine`` — planning
    is central, so the refit benefits every shard).
    """

    def __init__(self, engine: FilteredANNEngine, config: Optional[FeedbackConfig] = None,
                 labeler: Optional[Callable[[RuntimeRequest], int]] = None):
        if not hasattr(engine, "pre_exec"):
            raise ValueError(
                "OnlineFeedback needs a fully built engine (build(), not "
                "build_stats()): shadow labelling runs both executors"
            )
        self.engine = engine
        self.config = config or FeedbackConfig()
        self.labeler = labeler or self._shadow_label
        self.rng = np.random.default_rng(self.config.seed)
        self.log: List[LogEntry] = []
        self.n_observed = 0
        self.n_sampled = 0
        self.n_refits = 0
        self.n_swaps = 0
        self._since_refit = 0

    # ------------------------------------------------------------------
    def _shadow_label(self, req: RuntimeRequest):
        """Paper §3.1 labelling, online — delegates to the engine's shared
        :meth:`FilteredANNEngine.label_query` (the SAME rule the offline
        ``fit`` loop uses, so online and offline labels cannot drift).
        Returns the full :class:`QueryLabel` — for DNF requests it carries
        the per-clause races the clause-level log rows are built from."""
        return self.engine.label_query(req.query, req.pred, req.k)

    def observe(self, req: RuntimeRequest, res: PlannedResult) -> bool:
        """Called per served request; returns True when it was sampled into
        the log.  Sampling is seeded — which requests get shadow-labelled
        is replayable even though the measured labels are not.

        DNF requests log one clause-level row per unique disjunct (clause
        features, the ClausePlan's decision, the clause's own §3.1 race
        label/route) — the planner head only ever decides conjunctions, so
        whole-``Or`` rows would train it on features it never serves."""
        self.n_observed += 1
        if self.rng.random() >= self.config.sample_rate:
            return False
        labelled = self.labeler(req)
        lat = float(res.result.elapsed)
        if (isinstance(labelled, QueryLabel) and labelled.clauses
                and isinstance(req.pred, Or)):
            self._log_clauses(req, res, labelled, lat)
        else:
            # pluggable labelers may return a bare int (plan label only), a
            # (label, route) pair, or a QueryLabel
            if isinstance(labelled, QueryLabel):
                label, route = labelled.label, labelled.route
            elif isinstance(labelled, tuple):
                label, route = labelled
            else:
                label, route = labelled, NO_ROUTE
            se = self.engine.estimator.estimate(req.pred)
            fv = self.engine.feat.vector(req.pred, se.sel, req.k, se.is_exact)
            # the logged latency is what the SERVED strategy paid (its share
            # of the executed batch), not the shadow race's winner time
            self.log.append(LogEntry(fv, res.decision, int(label), lat,
                                     route=int(route)))
        if len(self.log) > self.config.max_log:
            self.log = self.log[-self.config.max_log:]
        self.n_sampled += 1
        self._since_refit += 1
        return True

    def _log_clauses(self, req: RuntimeRequest, res: PlannedResult,
                     ql: QueryLabel, lat: float) -> None:
        """One log row per unique disjunct of a DNF request.  Clause plans
        are matched by canonical key (term order varies across logically
        equal predicates); the row's latency is the whole request's share —
        clause-level timing is not observable from a merged result."""
        plan = getattr(res, "plan", None)
        by_key = ({c.clause_key: c for c in plan.clauses}
                  if plan is not None else {})
        se = self.engine.estimator.estimate(req.pred)
        seen: set = set()
        ci = 0
        for t, ce in zip(req.pred.terms, se.per_clause):
            key = self.engine._plan_key(t)
            if key in seen:
                continue
            seen.add(key)
            cl = ql.clauses[ci]
            ci += 1
            cp = by_key.get(key)
            dec = cp.decision if cp is not None else res.decision
            fv = self.engine.feat.vector(t, ce.sel, req.k, ce.is_exact)
            self.log.append(LogEntry(fv, int(dec), int(cl.label), lat,
                                     route=int(cl.route)))

    # ------------------------------------------------------------------
    def maybe_refit(self) -> bool:
        """Refit when enough new samples accumulated; returns True iff the
        candidate head was swapped in."""
        cfg = self.config
        if self._since_refit < cfg.refit_every or len(self.log) < cfg.min_examples:
            return False
        self._since_refit = 0
        return self.refit()

    def refit(self) -> bool:
        """One guarded refit attempt from the current log."""
        cfg = self.config
        x = np.stack([e.features for e in self.log])
        y = np.asarray([e.label for e in self.log], np.int32)
        self.n_refits += 1
        n = len(y)
        # deterministic holdout: seeded by (config seed, refit ordinal) so
        # successive refits don't always hold out the same rows
        perm = np.random.default_rng(cfg.seed + 7919 * self.n_refits).permutation(n)
        n_hold = max(1, int(round(cfg.holdout_frac * n)))
        hold, train = perm[:n_hold], perm[n_hold:]
        if (len(set(y[train].tolist())) < 2 or len(set(y[hold].tolist())) < 2):
            return False          # degenerate split: nothing to learn/guard
        candidate = self._fit_candidate(x, y, train)
        cand_auc = roc_auc(y[hold], candidate.predict_proba(x[hold]))
        current = self.engine.planner
        if current.params is not None:
            curr_auc = roc_auc(y[hold], current.predict_proba(x[hold]))
        else:
            curr_auc = -np.inf    # untrained fallback head: any fit beats it
        if cand_auc < curr_auc - cfg.auc_slack:
            return False          # drift guard: the new head regressed
        self.engine.swap_planner(candidate)
        self.n_swaps += 1
        return True

    def _fit_candidate(self, x: np.ndarray, y: np.ndarray,
                       train: np.ndarray) -> CorePlanner:
        """A candidate head fitted on the log's ``train`` rows, on the
        engine's device.  The routing head rides along: when the engine
        carries a backend roster and the log holds routed labels, the
        candidate learns the (backend, knob) head from the SAME train slice
        (guarded by the same plan-AUC swap decision — routing never swaps
        independently)."""
        cfg = self.config
        candidate = CorePlanner(
            n_features=x.shape[1], seed=cfg.seed + self.n_refits,
            device=self.engine.device,
        ).fit(x[train], y[train])
        backend_set = getattr(self.engine, "backend_set", None)
        if backend_set is not None:
            routes = np.asarray([e.route for e in self.log], np.int32)
            if (routes[train] >= 0).sum() >= 2:
                candidate.fit_routing(x[train], routes[train],
                                      backend_set.class_names())
        return candidate

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "observed": self.n_observed,
            "sampled": self.n_sampled,
            "log_size": len(self.log),
            "refits": self.n_refits,
            "swaps": self.n_swaps,
        }

    def publish(self, registry, **labels) -> None:
        """Export :meth:`stats` into a
        :class:`repro_torch.obs.metrics.MetricsRegistry` as
        ``repro_feedback_*`` gauges."""
        for key, v in self.stats().items():
            registry.set_gauge(f"repro_feedback_{key}", v, **labels)
