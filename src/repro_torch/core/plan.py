"""Structured query plans: ``ClausePlan`` and ``ExecutionPlan``.

Port of ``repro/core/plan.py``.  A :class:`ClausePlan` is the plan for one
conjunctive clause: its canonical key, the strategy decision, the resolved
``(backend, knob)`` execution class, the selectivity estimate it was
planned under and the routing-head class.  An :class:`ExecutionPlan` is an
ordered tuple of clause plans plus a merge spec: ``"none"`` is a
conjunction's single whole-predicate clause; ``"union"`` is a DNF plan
whose clauses run as ordinary decision-group rows
(:func:`expand_for_execution`) and whose top-k lists merge with cross-clause
de-duplication (:func:`collapse_clause_results`, through
:func:`repro_torch.dist.collectives.merge_topk_unique`).

Clause plans are keyed by the canonical key of their disjunct, not by term
position: ``Or`` predicates that differ only in term order share a
plan-cache entry, so execution aligns terms to clause plans by key.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .planner import INDEXED_PRE, POST_FILTER, PRE_FILTER

STRATEGY_NAMES = {PRE_FILTER: "pre", POST_FILTER: "post", INDEXED_PRE: "ipre"}

#: routing-head sentinel: the row was not (or could not be) routed to a
#: concrete backend class.
NO_ROUTE = -1


def default_route_name(decision: int) -> Tuple[str, str]:
    """Backend/knob pair implied by a decision when routing is off."""
    if decision == POST_FILTER:
        return "ivf", "adapt"
    return "flat", "exact"


@dataclasses.dataclass(frozen=True)
class ClausePlan:
    """Plan for one conjunctive clause."""

    clause_key: Tuple          # canonical_key of the clause
    decision: int              # PRE_FILTER / POST_FILTER / INDEXED_PRE
    backend: str               # resolved execution class, e.g. "ivf"
    knob: str                  # e.g. "adapt", "exact"
    est: float                 # estimated selectivity the plan was made under
    route: int = NO_ROUTE      # routing-head class index, NO_ROUTE if unrouted
    sel_exact: bool = False    # estimate came from a covering bitmap popcount


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Clause plans + how to combine their results (``"none"``: a single
    whole-predicate clause, executed directly; ``"union"``: per-disjunct
    DNF, each clause a decision-group row, merged with de-duplication)."""

    clauses: Tuple[ClausePlan, ...]
    est: float                 # whole-predicate selectivity estimate
    sel_exact: bool            # whole-predicate estimate is exact
    merge: str = "none"

    @property
    def n_clauses(self) -> int:
        return len(self.clauses)

    @property
    def is_dnf(self) -> bool:
        return self.merge == "union"

    def _dominant(self) -> ClausePlan:
        return max(self.clauses, key=lambda c: c.est)

    @property
    def decision(self) -> int:
        """Single-clause: that clause's decision; multi-clause: the largest-
        est clause's."""
        if not self.clauses:
            return PRE_FILTER
        if len(self.clauses) == 1:
            return self.clauses[0].decision
        return self._dominant().decision

    @property
    def backend(self) -> str:
        if self.is_dnf:
            return "dnf"
        return self.clauses[0].backend if self.clauses else ""

    @property
    def knob(self) -> str:
        if self.is_dnf:
            return ""
        return self.clauses[0].knob if self.clauses else ""

    @property
    def route(self) -> int:
        if self.is_dnf or not self.clauses:
            return NO_ROUTE
        return self.clauses[0].route

    @property
    def strategy(self) -> str:
        """Name used in result rows: "pre"/"post"/"ipre"/"dnf"."""
        return "dnf" if self.is_dnf else STRATEGY_NAMES[self.decision]


def clause_predicates(pred, plan: ExecutionPlan) -> List:
    """Concrete sub-predicates aligned with ``plan.clauses``: ``[pred]`` for
    ``merge == "none"``; for a DNF plan, the terms matched to the clauses by
    canonical key (the clauses were planned over the unique disjuncts in
    first-occurrence order of a possibly permuted ``Or``)."""
    from ..filter.cache import canonical_key

    if plan.merge == "none":
        return [pred]
    by_key = {}
    for t in getattr(pred, "terms", ()):
        by_key.setdefault(canonical_key(t), t)
    return [by_key[c.clause_key] for c in plan.clauses]


def expand_for_execution(preds: Sequence, plans: Sequence[ExecutionPlan]):
    """Flatten per-row plans into per-clause execution rows.

    Returns ``(exp_rows, exp_preds, decisions, ests, routes, row_map)``:
    ``exp_rows[j]`` is the batch row clause ``j`` belongs to (index the
    query matrix with it) and ``row_map[i]`` lists the expanded rows that
    collapse back into row ``i``.  Single-clause rows expand to themselves,
    so a batch without DNF plans round-trips as the identity."""
    exp_rows: List[int] = []
    exp_preds: List = []
    decisions: List[int] = []
    ests: List[float] = []
    routes: List[int] = []
    row_map: List[List[int]] = []
    for i, (pred, plan) in enumerate(zip(preds, plans)):
        rows = []
        for cp, cl in zip(clause_predicates(pred, plan), plan.clauses):
            rows.append(len(exp_preds))
            exp_rows.append(i)
            exp_preds.append(cp)
            decisions.append(cl.decision)
            ests.append(cl.est)
            routes.append(cl.route)
        row_map.append(rows)
    return (np.asarray(exp_rows, np.int64), exp_preds,
            np.asarray(decisions, np.int32), np.asarray(ests, np.float64),
            np.asarray(routes, np.int32), row_map)


def collapse_clause_results(d: np.ndarray, ids: np.ndarray,
                            rounds: np.ndarray, row_map: List[List[int]],
                            k: int):
    """Collapse expanded per-clause rows back to one row per query.

    Multi-clause rows merge their clause lists with cross-clause
    de-duplication (each id once, at its lowest (distance, id) key), so an
    exact-tier union reproduces the whole-predicate union-mask scan bit for
    bit; single-clause rows pass through; an empty ``Or`` stays all
    padding."""
    from ..dist.collectives import merge_topk_unique

    if all(len(rows) == 1 for rows in row_map):
        return d, ids, rounds
    b = len(row_map)
    out_d = np.full((b, k), np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    out_r = np.zeros(b, dtype=rounds.dtype)
    # multi-clause rows grouped by clause count: one merge call per group
    groups: dict = {}
    for i, rows in enumerate(row_map):
        if len(rows) == 1:
            out_d[i], out_i[i] = d[rows[0]], ids[rows[0]]
            out_r[i] = rounds[rows[0]]
        elif rows:
            groups.setdefault(len(rows), []).append(i)
    for members in groups.values():
        dd = np.stack([d[row_map[i]] for i in members], axis=1)    # (c, m, k)
        ii = np.stack([ids[row_map[i]] for i in members], axis=1)
        md, mi = merge_topk_unique(dd, ii, k)
        out_d[members], out_i[members] = md, mi
        out_r[members] = [int(rounds[row_map[i]].max()) for i in members]
    return out_d, out_i, out_r


def format_plan(plan: ExecutionPlan, pred=None) -> str:
    """Render a plan as a small tree — ``engine.explain``."""
    head = (f"ExecutionPlan merge={plan.merge} clauses={plan.n_clauses} "
            f"est={plan.est:.4f}{' (exact)' if plan.sel_exact else ''}")
    cps = clause_predicates(pred, plan) if pred is not None else None
    lines = [head]
    for j, cl in enumerate(plan.clauses):
        branch = "└─" if j == len(plan.clauses) - 1 else "├─"
        what = f" {cps[j]}" if cps is not None else ""
        route = f" route={cl.route}" if cl.route != NO_ROUTE else ""
        lines.append(
            f"{branch} clause[{j}]{what} -> {STRATEGY_NAMES[cl.decision]} "
            f"backend={cl.backend}:{cl.knob} est={cl.est:.4f}"
            f"{' (exact)' if cl.sel_exact else ''}{route}")
    return "\n".join(lines)


__all__ = [
    "PRE_FILTER", "POST_FILTER", "INDEXED_PRE", "STRATEGY_NAMES", "NO_ROUTE",
    "ClausePlan", "ExecutionPlan", "clause_predicates", "collapse_clause_results",
    "default_route_name", "expand_for_execution", "format_plan",
]
