"""Columnar device batches: Column and Table, on torch tensors.

Port of ``supersonic_tpu/batch.py`` (reference: base/infrastructure/
block.h:55-489):

  * ``Column`` = one dense value tensor + optional bool validity tensor.
  * ``Table``  = schema + dict of Columns + ``num_rows`` + an explicit
                 ``device``.  STRING/BINARY would be int32 codes with a
                 host-side Dictionary (not carried yet).

Decision: tables stay CAPACITY-PADDED, as in the JAX package.  Every
column has a static capacity (``values.shape[0]``); ``num_rows`` is a
python int for tables built on the host, or a 0-d int64 tensor on the
table's device for tables an operator produced, and says how many leading
rows are live (``row_mask()``).  Operators therefore never wait for the
device to learn a row count: a plan runs start to end without a host sync,
and ``execute`` reads the error flags back in one sync at the end.  It also
keeps overflow behaviour the same as the reference: an operator whose
result outgrows its planned capacity raises the same error flag
(``"aggregate result overflow"``, ``"join result overflow"``).  Rows past
``num_rows`` hold unspecified values.

Tables built on the host (``from_data``, ``from_numpy``) carry planner
statistics computed from the host arrays before the upload: per integer
column (min, max), and the columns whose values are the row position plus
a constant (dense primary keys).  ``ScanTable`` hands them to the planner,
so bind never reads the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .schema import SchemaError, TupleSchema
from .types import (DataType, check_column_type, physical_dtype,
                    torch_dtype)

_STAT_TYPES = (DataType.INT32, DataType.INT64)


class Column(NamedTuple):
    """One device column: values[capacity] (+ valid[capacity] if nullable)."""

    values: torch.Tensor
    valid: Optional[torch.Tensor]  # bool tensor, None => all rows valid

    @property
    def capacity(self) -> int:
        return self.values.shape[0]


def _host_stats(schema: TupleSchema, host: dict, n: int):
    """(stats, rowid) planner statistics from host arrays; ``host``
    maps name -> (values ndarray, valid ndarray or None) of the n live
    rows."""
    stats: dict = {}
    rowid: set = set()
    if n == 0:
        return stats, rowid
    for a in schema:
        if a.type not in _STAT_TYPES:
            continue
        vals, valid = host[a.name]
        if valid is not None:
            if not valid.any():
                continue
            all_valid = bool(valid.all())
            vals = vals[valid]
        else:
            all_valid = True
        mn, mx = int(vals.min()), int(vals.max())
        stats[a.name] = (mn, mx)
        if (all_valid and mx - mn + 1 == n
                and np.array_equal(vals, np.arange(mn, mn + n,
                                                   dtype=vals.dtype))):
            rowid.add(a.name)
    return stats, rowid


class Table:
    """Schema-carrying columnar batch on one device."""

    __slots__ = ("schema", "columns", "num_rows", "dicts", "device",
                 "_cap_hint", "stats", "rowid")

    def __init__(self, schema: TupleSchema, columns: dict[str, Column],
                 num_rows, device, dicts: Optional[dict] = None,
                 cap_hint: Optional[int] = None):
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows  # python int or 0-d int64 device tensor
        self.device = torch.device(device)
        self.dicts = dicts or {}
        self._cap_hint = cap_hint  # capacity of zero-column tables
        self.stats: dict = {}
        self.rowid: set = set()

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_numpy(schema: TupleSchema, arrays: dict, dicts, device,
                   capacity: Optional[int] = None) -> "Table":
        """Build a Table from host numpy column arrays: the arrays the JAX
        package holds (``np.asarray`` of its columns) become this port's
        table on ``device``, so both engines run on identical data.

        ``arrays[name]`` is a value ndarray, or a ``(values, valid)`` pair
        for a nullable column.  Rows past ``len`` up to ``capacity`` are
        padding.
        """
        for a in schema:
            check_column_type(a.type)
            if a.name not in arrays:
                raise SchemaError(f"column {a.name!r} missing from data")
        host: dict = {}
        n = None
        for a in schema:
            raw = arrays[a.name]
            vals, valid = raw if isinstance(raw, tuple) else (raw, None)
            vals = np.ascontiguousarray(vals, dtype=physical_dtype(a.type))
            if valid is not None:
                valid = np.ascontiguousarray(valid, dtype=bool)
                if valid.shape != vals.shape:
                    raise SchemaError("validity length != value length")
                if not a.nullable:
                    if not valid.all():
                        raise SchemaError(
                            f"NULL in non-nullable column {a.name!r}")
                    valid = None
            if n is None:
                n = vals.shape[0]
            elif vals.shape[0] != n:
                raise SchemaError("ragged columns")
            host[a.name] = (vals, valid)
        n = n or 0
        cap = capacity or max(n, 1)
        if cap < n:
            raise SchemaError("capacity < row count")
        device = torch.device(device)
        columns = {}
        for a in schema:
            vals, valid = host[a.name]
            if cap == n:
                t = torch.from_numpy(vals).to(device, copy=True)
            else:
                t = torch.zeros(cap, dtype=torch_dtype(a.type), device=device)
                t[:n] = torch.from_numpy(vals).to(device)
            v = None
            if a.nullable:
                v = torch.zeros(cap, dtype=torch.bool, device=device)
                v[:n] = (torch.ones(n, dtype=torch.bool) if valid is None
                         else torch.from_numpy(valid)).to(device)
            columns[a.name] = Column(t, v)
        table = Table(schema, columns, n, device, dict(dicts or {}))
        table.stats, table.rowid = _host_stats(schema, host, n)
        return table

    @staticmethod
    def from_data(schema: TupleSchema, data: dict, device,
                  capacity: Optional[int] = None, dicts=None) -> "Table":
        """Build a Table from python sequences (None entries = NULL) or
        numpy arrays."""
        arrays = {}
        for a in schema:
            check_column_type(a.type)
            if a.name not in data:
                raise SchemaError(f"column {a.name!r} missing from data")
            raw = data[a.name]
            if isinstance(raw, np.ndarray) and raw.dtype != object:
                arrays[a.name] = raw
                continue
            lst = list(raw)
            valid = np.array([v is not None for v in lst], dtype=bool)
            vals = np.array([v if v is not None else 0 for v in lst],
                            dtype=physical_dtype(a.type))
            if not a.nullable and not valid.all():
                raise SchemaError(f"NULL in non-nullable column {a.name!r}")
            arrays[a.name] = (vals, valid) if a.nullable else vals
        return Table.from_numpy(schema, arrays, dicts, device, capacity)

    # -- inspection -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        names = self.schema.names()
        if not names:
            return self._cap_hint if self._cap_hint is not None else 1
        return self.columns[names[0]].capacity

    def row_mask(self) -> torch.Tensor:
        """bool[capacity]: True for live rows."""
        return (torch.arange(self.capacity, device=self.device)
                < self.num_rows)

    # -- host materialization -------------------------------------------------
    def to_numpy(self) -> dict[str, np.ndarray]:
        """Live rows on the host (object arrays, None = NULL, for nullable
        columns)."""
        n = int(self.num_rows)
        out: dict[str, np.ndarray] = {}
        for attr in self.schema:
            col = self.columns[attr.name]
            vals = col.values[:n].cpu().numpy()
            if attr.type == DataType.UINT64:
                vals = vals.view(np.uint64)
            if attr.type in (DataType.STRING, DataType.BINARY):
                decoded = self.dicts[attr.name].decode(vals)
                if col.valid is not None:
                    decoded[~col.valid[:n].cpu().numpy()] = None
                out[attr.name] = decoded
            elif col.valid is not None:
                valid = col.valid[:n].cpu().numpy()
                obj = np.empty(n, dtype=object)
                for i in range(n):
                    obj[i] = vals[i].item() if valid[i] else None
                out[attr.name] = obj
            else:
                out[attr.name] = vals
        return out

    def to_pylist(self) -> list[tuple]:
        """Live rows as python tuples (None = NULL)."""
        cols = self.to_numpy()
        names = self.schema.names()
        rows = []
        for i in range(int(self.num_rows)):
            rows.append(tuple(
                (cols[c][i].item() if isinstance(cols[c][i], np.generic)
                 else cols[c][i]) for c in names))
        return rows

    def __repr__(self) -> str:
        return (f"Table({self.schema!r}, num_rows={self.num_rows}, "
                f"capacity={self.capacity}, device={self.device})")


def gather_arrays(arrays: Sequence[torch.Tensor],
                  safe_indices: torch.Tensor) -> list:
    """Gather rows of several equal-length 1-D arrays at the same int32
    indices (clipped into range), in one ``lut_gather`` launch on CUDA:
    every lane, of any width, shares the index read."""
    from .kernels.lut_gather import lut_gather

    if not arrays:
        return []
    return lut_gather(list(arrays), safe_indices, arrays[0].shape[0])


def gather_table(table: Table, indices: torch.Tensor, num_rows) -> Table:
    """A new Table of the rows of ``table`` at int32 ``indices`` (clipped
    into range), every column and validity mask in one gather."""
    jobs: list = []
    layout: list = []  # (name, has_valid)
    for attr in table.schema:
        col = table.columns[attr.name]
        jobs.append(col.values)
        if col.valid is not None:
            jobs.append(col.valid)
        layout.append((attr.name, col.valid is not None))
    gathered = iter(gather_arrays(jobs, indices))
    cols: dict[str, Column] = {}
    for name, has_valid in layout:
        vals = next(gathered)
        cols[name] = Column(vals, next(gathered) if has_valid else None)
    return Table(table.schema, cols, num_rows, table.device,
                 dict(table.dicts), cap_hint=indices.shape[0])
