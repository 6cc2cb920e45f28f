"""Operator surface of the port (so far: scan, filter, project, INNER and
LEFT_OUTER joins over dense integer keys with UNIQUE or NOT_UNIQUE rhs,
dense group-by, sort, MergeUnionAll and UnionAll)."""
from .aggregate import (AggregationSpecification, AggSpec, Aggregation,
                        GroupAggregate, GroupAggregateOptions)
from .base import (BindContext, BoundOperation, CancellationToken,
                   Interrupted, Operation, RunContext, compile_plan, execute)
from .filter import Filter
from .hash_join import HashJoin, JoinType, KeyUniqueness
from .merge import MergeUnionAll
from .project import Project, Projector
from .scan import ScanTable, ScanView
from .sort import Sort, SortKey, SortOrder
from .union import UnionAll

__all__ = [
    "AggSpec", "Aggregation", "AggregationSpecification", "BindContext",
    "BoundOperation", "CancellationToken", "Filter", "GroupAggregate",
    "GroupAggregateOptions", "HashJoin", "Interrupted", "JoinType",
    "KeyUniqueness", "MergeUnionAll", "Operation", "Project", "Projector",
    "RunContext", "ScanTable", "ScanView", "Sort", "SortKey", "SortOrder",
    "UnionAll", "compile_plan", "execute",
]
