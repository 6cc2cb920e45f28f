"""Leaf operation: scan a materialized Table.

Port of ``ScanTable`` and its planner statistics from
``supersonic_tpu/ops/scan.py`` (reference: cursor/infrastructure/
view_cursor.h:22-28, cursor/core/scan_view.h:24-40).  The statistics were
computed from the host arrays when the table was built (batch.py), so
binding a scan never reads the device.
"""
from __future__ import annotations

from ..batch import Table
from .base import BindContext, BoundOperation, Operation, RunContext


def table_stats(table: Table) -> dict:
    """Per-integer-column (min, max) over live rows."""
    return dict(table.stats)


def table_rowid_cols(table: Table, stats: dict) -> set:
    """Columns whose live values are exactly ``min + row position`` (dense
    ascending primary keys, the reference's row-id join precondition,
    rowid_merge_join.h:24-40)."""
    return {n for n in table.rowid if n in stats}


class ScanTable(Operation):
    """Scan a materialized Table (the leaf of every plan)."""

    def __init__(self, table: Table):
        self.table = table

    def bind(self, ctx: BindContext) -> BoundOperation:
        idx = ctx.register_leaf(self.table)

        def fn(rctx: RunContext) -> Table:
            return rctx.leaf_tables[idx]

        stats = table_stats(self.table)
        return BoundOperation(self.table.schema, dict(self.table.dicts), fn,
                              self.table.capacity, stats=stats,
                              rowid=table_rowid_cols(self.table, stats))


ScanView = ScanTable
