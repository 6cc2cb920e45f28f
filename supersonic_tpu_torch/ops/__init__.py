"""Operator surface of the port: scan, filter, project, compute, limit,
generate, coalesce, hash joins of every JoinType over keys of every carried
column type with UNIQUE or NOT_UNIQUE rhs, the row-id joins, group-by
(dense, sort path, DISTINCT, key clamps, memory quotas, CONCAT), the
best-effort, hybrid (spilling under a quota), scalar and cluster
aggregates, sort (in memory, extended, and spilling under a memory limit),
MergeUnionAll, UnionAll, plan sharing and spies.
"""
from .aggregate import (AggregateClusters,
                        AggregateClustersWithSpecifiedOutputBlockSize,
                        AggregationSpecification, AggSpec, Aggregation,
                        BestEffortGroupAggregate, GroupAggregate,
                        GroupAggregateOptions, HybridGroupAggregate,
                        ScalarAggregate)
from .base import (BindContext, BoundOperation, CancellationToken,
                   Interrupted, Operation, RunContext, bind_plan, compile_plan,
                   execute, set_debug_checks)
from .coalesce import Coalesce
from .compute import Compute
from .filter import Filter, compact_by_mask, compaction_indices
from .generate import Generate
from .hash_join import HashJoin, JoinType, KeyUniqueness
from .host import group_concat, to_string
from .limit import Limit
from .merge import MergeUnionAll
from .misc import (SharedOperation, Spy, SpyListener, TakeOwnership,
                   format_table)
from .project import Project, Projector
from .rowid_join import ForeignFilter, RowidMergeJoin
from .scan import (ScanTable, ScanTableWithSelection, ScanView,
                   ScanViewWithSelection)
from .sort import (ExtendedSort, Sort, SortKey, SortOrder,
                   SortWithTempDirPrefix, sort_permutation)
from .union import UnionAll

__all__ = [
    "AggSpec", "AggregateClusters",
    "AggregateClustersWithSpecifiedOutputBlockSize", "Aggregation",
    "AggregationSpecification", "BestEffortGroupAggregate", "BindContext",
    "BoundOperation", "CancellationToken", "Coalesce", "Compute",
    "ExtendedSort", "Filter", "ForeignFilter", "Generate", "GroupAggregate",
    "GroupAggregateOptions", "HashJoin", "HybridGroupAggregate",
    "Interrupted", "JoinType", "KeyUniqueness", "Limit", "MergeUnionAll",
    "Operation", "Project", "Projector", "RowidMergeJoin", "RunContext",
    "ScalarAggregate", "ScanTable", "ScanTableWithSelection", "ScanView",
    "ScanViewWithSelection", "SharedOperation", "Sort", "SortKey",
    "SortOrder", "SortWithTempDirPrefix", "Spy", "SpyListener",
    "TakeOwnership", "UnionAll", "bind_plan", "compact_by_mask",
    "compaction_indices", "compile_plan", "execute", "format_table",
    "group_concat", "set_debug_checks", "sort_permutation", "to_string",
]
