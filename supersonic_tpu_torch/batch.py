"""Columnar device batches: Column and Table, on torch tensors.

Port of ``supersonic_tpu/batch.py`` (reference: base/infrastructure/
block.h:55-489):

  * ``Column`` = one dense value tensor + optional bool validity tensor.
  * ``Table``  = schema + dict of Columns + ``num_rows`` + an explicit
                 ``device``.  STRING/BINARY columns are int32 codes into a
                 sorted host-side Dictionary (``dicts[name]``), so code
                 order is value order.

Decision: tables stay CAPACITY-PADDED, as in the JAX package.  Every
column has a static capacity (``values.shape[0]``); ``num_rows`` is a
python int for tables built on the host, or a 0-d int64 tensor on the
table's device for tables an operator produced, and says how many leading
rows are live (``row_mask()``).  Operators therefore do not wait for the
device to learn a row count, with two exceptions, each reading a live row
count once because every later pass needs a length and eager PyTorch
cannot give one without the host: the sort-path group-by (sync
``agg.num_rows``, ops/aggregate.py), since sorting the capacity costs far
more than the read where a filter or a join keeps few rows; and a join
that compacts its output (sync ``join.num_rows``, ops/hash_join.py),
which hands on the prefix of its survivors, so the joins, expressions and
aggregates above it run over those rows and not over the lhs capacity.
Every other operator runs without a host sync, and ``execute`` reads the
error flags back in one sync at the end.  It also
keeps overflow behaviour the same as the reference: an operator whose
result outgrows its planned capacity raises the same error flag
(``"aggregate result overflow"``, ``"join result overflow"``).  Rows past
``num_rows`` hold unspecified values.

Tables built on the host (``from_data``, ``from_numpy``) carry planner
statistics computed from the host arrays before the upload: per INT32,
INT64, UINT32, DATE, DATETIME and ENUM column (min, max), and the columns
whose values are the row position plus a constant (dense primary keys).
``ScanTable`` hands them to the planner, so bind never reads the device.
``from_arrays`` (the constructor of the file readers and the external
sort) and ``empty`` build on ``from_numpy``; ``concat_tables`` joins the
live rows of tables, their dictionaries merged.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import tracing
from .dictionary import Dictionary, encode, merge
from .schema import Attribute, SchemaError, TupleSchema
from .types import (DataType, check_column_type, from_carrier,
                    is_variable_length, physical_dtype, to_carrier,
                    torch_dtype)

# columns with host (min, max) statistics: the JAX package's list
# (supersonic_tpu/ops/scan.py::table_stats)
_STAT_TYPES = (DataType.INT32, DataType.INT64, DataType.UINT32,
               DataType.DATE, DataType.DATETIME, DataType.ENUM)


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
    for a in schema:
        if a.type not in _STAT_TYPES:
            continue
        vals, valid = host[a.name]
        all_valid = valid is None or bool(valid.all())
        if valid is not None:
            vals = vals[valid]
        if vals.size == 0:
            # no non-NULL live value, so any bound holds: one slot keeps
            # the dense plans (a join against an empty build side) open
            stats[a.name] = (0, 0)
            continue
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
    def from_numpy(schema: TupleSchema, arrays: dict,
                   capacity: Optional[int] = None,
                   dicts: Optional[dict] = None, *,
                   device="cuda") -> "Table":
        """Build a Table from host numpy column arrays: the arrays the JAX
        package holds (``np.asarray`` of its columns) become this port's
        table on ``device`` (the card unless the caller asks for another),
        so both engines run on identical data.

        ``arrays[name]`` is a value ndarray, or a ``(values, valid)`` pair
        for a nullable column; a STRING/BINARY column gives its int32 codes
        and ``dicts[name]`` its Dictionary.  Rows past ``len`` up to
        ``capacity`` are padding.  The positional order is the JAX
        package's ``from_data(schema, data, capacity, dicts)``.
        """
        for a in schema:
            check_column_type(a.type)
            if a.name not in arrays:
                raise SchemaError(f"column {a.name!r} missing from data")
            if is_variable_length(a.type) and a.name not in (dicts or {}):
                raise SchemaError(f"{a.type.value} column {a.name!r} needs "
                                  "its dictionary in dicts")
        host: dict = {}
        n = None
        for a in schema:
            raw = arrays[a.name]
            vals, valid = raw if isinstance(raw, tuple) else (raw, None)
            vals = np.ascontiguousarray(vals, dtype=physical_dtype(a.type))
            if not vals.flags.writeable:  # torch.from_numpy needs it
                vals = vals.copy()
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
            vals = to_carrier(vals, a.type)
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
    def from_arrays(schema: TupleSchema, values: dict, valids: dict,
                    num_rows: int, dicts: Optional[dict] = None,
                    capacity: Optional[int] = None, *,
                    device="cuda") -> "Table":
        """Build a Table from host arrays already in each type's physical
        dtype (no per-row Python work): ``values[name]`` holds ``num_rows``
        values, ``valids[name]`` an optional bool mask (None: every row
        valid); a STRING/BINARY column gives its codes and ``dicts[name]``
        its Dictionary.  The constructor of the file readers and the
        external sort; the JAX package's ``from_arrays`` with ``device``
        (the card unless the caller asks for another)."""
        arrays = {}
        for a in schema:
            vals = values[a.name]
            if len(vals) != num_rows:
                raise SchemaError("array length != num_rows")
            valid = valids.get(a.name)
            if valid is not None and not a.nullable:
                if not np.asarray(valid)[:num_rows].all():
                    raise SchemaError(
                        f"NULL in non-nullable column {a.name!r}")
                valid = None
            arrays[a.name] = vals if valid is None else (vals, valid)
        return Table.from_numpy(schema, arrays, capacity, dicts,
                                device=device)

    @staticmethod
    def empty(schema: TupleSchema, capacity: int = 1, *,
              device="cuda") -> "Table":
        """A Table of no rows and ``capacity`` zeroed rows on ``device``."""
        return Table.from_numpy(
            schema, {a.name: np.zeros(0, physical_dtype(a.type))
                     for a in schema}, capacity,
            {a.name: Dictionary(()) for a in schema
             if is_variable_length(a.type)}, device=device)

    @staticmethod
    def from_data(schema: TupleSchema, data: dict,
                  capacity: Optional[int] = None, dicts: Optional[dict] = None,
                  *, device="cuda") -> "Table":
        """Build a Table from python sequences (None entries = NULL) or
        numpy arrays; the arguments are those of ``from_numpy``.  A
        STRING/BINARY column given as str/bytes values (None = NULL) is
        dictionary-encoded, unless ``dicts`` has its dictionary: then the
        data are its codes.  An ENUM column may give value names, which map
        to their codes through the attribute's ``EnumDefinition``."""
        arrays = {}
        dicts = dict(dicts or {})
        for a in schema:
            check_column_type(a.type)
            if a.name not in data:
                raise SchemaError(f"column {a.name!r} missing from data")
            raw = data[a.name]
            if is_variable_length(a.type) and a.name not in dicts:
                vals, valid, dicts[a.name] = encode(list(raw))
            elif isinstance(raw, np.ndarray) and raw.dtype != object:
                arrays[a.name] = raw
                continue
            else:
                lst = list(raw)
                if a.type == DataType.ENUM:
                    lst = [a.enum.code_of(v) if isinstance(v, str) else v
                           for v in lst]
                valid = np.array([v is not None for v in lst], dtype=bool)
                vals = np.array([v if v is not None else 0 for v in lst],
                                dtype=physical_dtype(a.type))
            if not a.nullable and not valid.all():
                raise SchemaError(f"NULL in non-nullable column {a.name!r}")
            arrays[a.name] = (vals, valid) if a.nullable else vals
        return Table.from_numpy(schema, arrays, capacity, dicts, device=device)

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
        columns; ENUM columns as object arrays of value names).  One host
        sync for the row count and one a column and validity mask."""
        with tracing.span("query.copy"):
            n = int(tracing.to_host(self.num_rows, "copy.num_rows"))
            out: dict[str, np.ndarray] = {}
            for attr in self.schema:
                col = self.columns[attr.name]
                vals = from_carrier(
                    tracing.to_host(col.values[:n], "copy.values").numpy(),
                    attr.type)
                valid = (None if col.valid is None else tracing.to_host(
                    col.valid[:n], "copy.valid").numpy())
                if attr.type in (DataType.STRING, DataType.BINARY):
                    decoded = self.dicts[attr.name].decode(vals)
                    if valid is not None:
                        decoded[~valid] = None
                    out[attr.name] = decoded
                elif attr.type == DataType.ENUM:
                    if valid is None:
                        valid = np.ones(n, dtype=bool)
                    names = np.empty(n, dtype=object)
                    for i in range(n):
                        names[i] = (attr.enum.name_of(int(vals[i]))
                                    if valid[i] else None)
                    out[attr.name] = names
                elif valid is not None:
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
        for i in range(int(tracing.to_host(self.num_rows, "copy.num_rows"))):
            rows.append(tuple(
                (cols[c][i].item() if isinstance(cols[c][i], np.generic)
                 else cols[c][i]) for c in names))
        return rows

    def __repr__(self) -> str:
        return (f"Table({self.schema!r}, num_rows={self.num_rows}, "
                f"capacity={self.capacity}, device={self.device})")


def pad_table(table: Table, cap: int) -> Table:
    """``table`` with its columns zero-padded to ``cap`` rows (as it is
    where it holds as many already)."""
    if table.capacity >= cap:
        return table

    def pad(x):
        return torch.cat([x, x.new_zeros(cap - x.shape[0])])

    cols = {n: Column(pad(c.values), None if c.valid is None
                      else pad(c.valid)) for n, c in table.columns.items()}
    return Table(table.schema, cols, table.num_rows, table.device,
                 table.dicts, cap_hint=cap)


def gather_arrays(arrays: Sequence[torch.Tensor],
                  safe_indices: torch.Tensor) -> list:
    """Gather rows of several equal-length 1-D arrays at the same int32
    indices (clipped into range), in one ``lut_gather`` launch on CUDA a
    group of up to ``MAX_ARRAYS`` lanes: every lane of a group, of any
    width, shares the index read."""
    from .kernels import MAX_ARRAYS
    from .kernels.lut_gather import lut_gather

    out: list = []
    for i in range(0, len(arrays), MAX_ARRAYS):
        out += lut_gather(list(arrays[i:i + MAX_ARRAYS]), safe_indices,
                          arrays[0].shape[0])
    return out


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


def concat_tables(tables: Sequence[Table]) -> Table:
    """The live rows of same-schema tables, in order, as one table on the
    first table's device.  STRING/BINARY dictionaries merge (each table's
    codes remapped into the merged one through ``take_small``); a column is
    nullable if it is in any table; the padding rows between the live
    blocks are compacted away by the compaction kernel.  Port of
    ``supersonic_tpu/batch.py::concat_tables``."""
    from .kernels.lut_gather import BoundLut, take_small
    from .ops.filter import compact_by_mask

    if not tables:
        raise ValueError("concat_tables needs at least one table")
    schema = tables[0].schema
    for t in tables[1:]:
        if t.schema.names() != schema.names():
            raise SchemaError("concat over mismatched schemas")
    dev = tables[0].device
    dicts: dict = {}
    remaps: list = [dict() for _ in tables]
    for a in schema:
        if not is_variable_length(a.type):
            continue
        merged = tables[0].dicts[a.name]
        maps = [np.arange(max(len(merged), 1), dtype=np.int32)]
        for i, t in enumerate(tables[1:], start=1):
            merged, ra, rb = merge(merged, t.dicts[a.name])
            maps = [ra[m] for m in maps] + [rb]
        dicts[a.name] = merged
        for j, m in enumerate(maps):
            remaps[j][a.name] = m
    attrs = [Attribute(a.name, a.type,
                       any(t.schema.lookup(a.name).nullable for t in tables),
                       a.enum) for a in schema]
    cols = {}
    for a in attrs:
        vals, valid = [], []
        for t, remap in zip(tables, remaps):
            c = t.columns[a.name]
            v = c.values.to(dev)
            if a.name in remap:
                v = take_small(BoundLut(remap[a.name]), v)
            vals.append(v)
            if a.nullable:
                valid.append(torch.ones_like(v, dtype=torch.bool)
                             if c.valid is None else c.valid.to(dev))
        cols[a.name] = Column(torch.cat(vals),
                              torch.cat(valid) if a.nullable else None)
    live = torch.cat([t.row_mask().to(dev) for t in tables])
    out = Table(TupleSchema(attrs), cols, 0, dev,
                dicts or dict(tables[0].dicts))
    return compact_by_mask(out, live, out.capacity)
