"""Operator surface of the port (so far: scan, filter, project, compute,
hash joins of every JoinType over keys of every carried column type with
UNIQUE or NOT_UNIQUE rhs, group-by (dense, sort path and the aggregate
pushdown), sort, MergeUnionAll and UnionAll)."""
from .aggregate import (AggregationSpecification, AggSpec, Aggregation,
                        GroupAggregate, GroupAggregateOptions)
from .base import (BindContext, BoundOperation, CancellationToken,
                   Interrupted, Operation, RunContext, compile_plan, execute)
from .compute import Compute
from .filter import Filter
from .hash_join import HashJoin, JoinType, KeyUniqueness
from .merge import MergeUnionAll
from .project import Project, Projector
from .scan import ScanTable, ScanView
from .sort import Sort, SortKey, SortOrder
from .union import UnionAll

__all__ = [
    "AggSpec", "Aggregation", "AggregationSpecification", "BindContext",
    "BoundOperation", "CancellationToken", "Compute", "Filter", "GroupAggregate",
    "GroupAggregateOptions", "HashJoin", "Interrupted", "JoinType",
    "KeyUniqueness", "MergeUnionAll", "Operation", "Project", "Projector",
    "RunContext", "ScanTable", "ScanView", "Sort", "SortKey", "SortOrder",
    "UnionAll", "compile_plan", "execute",
]
