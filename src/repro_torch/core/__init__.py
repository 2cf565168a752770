from .predicates import LabelEq, Predicate, RangePred, Not, Or, AnyPredicate, iter_leaves, NULL_CODE
from .stats import DatasetStats
from .selectivity import SelEstimate, SelectivityEstimator
from .planner import CorePlanner, PlannerFeatures, PRE_FILTER, POST_FILTER, INDEXED_PRE
from .plan import ClausePlan, ExecutionPlan, NO_ROUTE, STRATEGY_NAMES, format_plan
from .executors import (
    PreFilterExec, IndexedPreFilterExec, PostFilterExec,
    SearchResult, recall_at_k,
)
from .corpus import CompactionPolicy, LiveCorpus
from .engine import (
    CorpusShard, FilteredANNEngine, EngineConfig, PlannedResult, QueryResult, QueryLabel,
)
from .trainer import gen_queries, gen_predicate
from .gbm import GradientBoostingRegressor

__all__ = [
    "LabelEq", "Predicate", "RangePred", "Not", "Or", "AnyPredicate",
    "iter_leaves", "NULL_CODE",
    "DatasetStats", "SelEstimate", "SelectivityEstimator",
    "CorePlanner", "PlannerFeatures", "PRE_FILTER", "POST_FILTER", "INDEXED_PRE",
    "ClausePlan", "ExecutionPlan", "NO_ROUTE", "STRATEGY_NAMES", "format_plan",
    "PreFilterExec", "IndexedPreFilterExec", "PostFilterExec",
    "SearchResult", "recall_at_k",
    "FilteredANNEngine", "EngineConfig", "PlannedResult", "QueryResult",
    "QueryLabel", "CorpusShard", "LiveCorpus", "CompactionPolicy",
    "gen_queries", "gen_predicate",
    "GradientBoostingRegressor",
]
