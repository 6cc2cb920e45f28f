"""Operator surface of the port (the slice: scan, filter, project, dense
UNIQUE INNER join, dense group-by, sort)."""
from .aggregate import (AggregationSpecification, AggSpec, Aggregation,
                        GroupAggregate, GroupAggregateOptions)
from .base import (BindContext, BoundOperation, CancellationToken,
                   Interrupted, Operation, RunContext, compile_plan, execute)
from .filter import Filter
from .hash_join import HashJoin, JoinType, KeyUniqueness
from .project import Project, Projector
from .scan import ScanTable, ScanView
from .sort import Sort, SortKey, SortOrder

__all__ = [
    "AggSpec", "Aggregation", "AggregationSpecification", "BindContext",
    "BoundOperation", "CancellationToken", "Filter", "GroupAggregate",
    "GroupAggregateOptions", "HashJoin", "Interrupted", "JoinType",
    "KeyUniqueness", "Operation", "Project", "Projector", "RunContext",
    "ScanTable", "ScanView", "Sort", "SortKey", "SortOrder", "compile_plan",
    "execute",
]
