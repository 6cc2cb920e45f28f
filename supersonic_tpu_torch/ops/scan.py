"""Leaf operation: scan a materialized Table.

Port of ``ScanTable``, ``ScanTableWithSelection`` and the planner
statistics from
``supersonic_tpu/ops/scan.py`` (reference: cursor/infrastructure/
view_cursor.h:22-28, cursor/core/scan_view.h:24-40).  The statistics were
computed from the host arrays when the table was built (batch.py), so
binding a scan never reads the device.
"""
from __future__ import annotations

import torch

from ..batch import Table, gather_table
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
                              rowid=table_rowid_cols(self.table, stats),
                              timed=False)


class ScanTableWithSelection(Operation):
    """Scan a table through a row-id selection vector, gathering on read
    (reference: view_cursor.cc:77).  An id outside the table reads row 0,
    as the JAX package's gather does."""

    def __init__(self, table: Table, selection, num_rows=None):
        self.table = table
        sel = torch.as_tensor(selection, device=table.device).to(torch.int32)
        self.selection = torch.where((sel < 0) | (sel >= table.capacity),
                                     0, sel)
        self.num_rows = (num_rows if num_rows is not None
                         else self.selection.shape[0])

    def bind(self, ctx: BindContext) -> BoundOperation:
        idx = ctx.register_leaf(self.table)
        sel, n = self.selection, self.num_rows

        def fn(rctx: RunContext) -> Table:
            return gather_table(rctx.leaf_tables[idx], sel, n)

        return BoundOperation(self.table.schema, dict(self.table.dicts), fn,
                              sel.shape[0])


# reference naming (scan_view.h:24-40): a caller-owned View is a Table here
ScanView = ScanTable
ScanViewWithSelection = ScanTableWithSelection
