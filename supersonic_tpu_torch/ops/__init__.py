"""Operator surface of the port: scan, filter, project, compute, limit,
generate, coalesce, hash joins of every JoinType over keys of every carried
column type with UNIQUE or NOT_UNIQUE rhs, the row-id joins, group-by
(dense, sort path, the aggregate pushdown, DISTINCT, key clamps, memory
quotas, CONCAT), the best-effort, hybrid (without a quota), scalar and
cluster aggregates, sort, MergeUnionAll, UnionAll, plan sharing and spies.
"""
from .aggregate import (AggregateClusters,
                        AggregateClustersWithSpecifiedOutputBlockSize,
                        AggregationSpecification, AggSpec, Aggregation,
                        BestEffortGroupAggregate, GroupAggregate,
                        GroupAggregateOptions, HybridGroupAggregate,
                        ScalarAggregate)
from .base import (BindContext, BoundOperation, CancellationToken,
                   Interrupted, Operation, RunContext, compile_plan, execute)
from .coalesce import Coalesce
from .compute import Compute
from .filter import Filter, compact_by_mask
from .generate import Generate
from .hash_join import HashJoin, JoinType, KeyUniqueness
from .host import group_concat, to_string
from .limit import Limit
from .merge import MergeUnionAll
from .misc import (SharedOperation, Spy, SpyListener, TakeOwnership,
                   format_table)
from .project import Project, Projector
from .rowid_join import ForeignFilter, RowidMergeJoin
from .scan import ScanTable, ScanView
from .sort import Sort, SortKey, SortOrder, sort_permutation
from .union import UnionAll

__all__ = [
    "AggSpec", "AggregateClusters",
    "AggregateClustersWithSpecifiedOutputBlockSize", "Aggregation",
    "AggregationSpecification", "BestEffortGroupAggregate", "BindContext",
    "BoundOperation", "CancellationToken", "Coalesce", "Compute", "Filter",
    "ForeignFilter", "Generate", "GroupAggregate", "GroupAggregateOptions",
    "HashJoin", "HybridGroupAggregate", "Interrupted", "JoinType",
    "KeyUniqueness", "Limit", "MergeUnionAll", "Operation", "Project",
    "Projector", "RowidMergeJoin", "RunContext", "ScalarAggregate",
    "ScanTable", "ScanView", "SharedOperation", "Sort", "SortKey",
    "SortOrder", "Spy", "SpyListener", "TakeOwnership", "UnionAll",
    "compact_by_mask", "compile_plan", "execute", "format_table",
    "group_concat", "sort_permutation", "to_string",
]
