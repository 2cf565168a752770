"""Structured query plans: ``ClausePlan`` and ``ExecutionPlan``.

Port of ``repro/core/plan.py``.  A :class:`ClausePlan` is the plan for one
conjunctive clause: its canonical key, the strategy decision, the resolved
``(backend, knob)`` execution class, the selectivity estimate it was
planned under and the routing-head class.  An :class:`ExecutionPlan` is an
ordered tuple of clause plans plus a merge spec.  This slice plans only
conjunctions (``merge == "none"``, one clause); per-disjunct DNF plans and
their ``"union"`` merge are ported later, and the engine refuses ``Or``
predicates until then.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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
    DNF, not in this slice)."""

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


def format_plan(plan: ExecutionPlan, pred=None) -> str:
    """Render a plan as a small tree — ``engine.explain``."""
    head = (f"ExecutionPlan merge={plan.merge} clauses={plan.n_clauses} "
            f"est={plan.est:.4f}{' (exact)' if plan.sel_exact else ''}")
    cps = [pred] if pred is not None and plan.merge == "none" else None
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
    "ClausePlan", "ExecutionPlan", "default_route_name", "format_plan",
]
