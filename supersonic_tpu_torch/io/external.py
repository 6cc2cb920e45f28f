"""External (disk-spilling) merge sort.

Port of ``supersonic_tpu/io/external.py`` (reference: cursor/core/
sort.cc's external path: ``BufferingSorter`` (:467) buffers input up to a
memory limit, flushes sorted runs to temp files (``BasicMerger::
AddSorted``, :332-362), and the final ``Merge`` (:366-392) k-way merges
the run files and the last in-memory run).

Runs are sorted on the input tables' device by ``ops/sort.sort_table`` and
spilled through the columnar file format (``io/file_io.py``); a table fed
by ``write`` stays on its device until its run spills, so it crosses to
the host once.  ``result`` merges the runs on the host: each sort key
becomes uint64 code lanes (``_host_code_lanes``) and the port's C++ k-way
merge (``native.kway_merge``) orders the rows; the merged table then
crosses to the device once.  Without the C++ library, or before any run
spilled, ``result`` takes the JAX package's Python route
(``result_chunks``, a ``heapq`` merge of the run files' rows).

The semantics are the JAX package's exactly, with its mismatch kept: the
device runs order a FLOAT key by the total order of its bits (-0.0 before
+0.0, a NaN by its sign), while the host lanes count -0.0 equal to +0.0
and put every NaN last.  Run files live in a directory made under
``temporary_directory_prefix`` (or the system's temporary directory) and
are removed by ``close``.
"""
from __future__ import annotations

import heapq
import os
import tempfile
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .. import native, tracing
from ..batch import Column, Table, concat_tables
from ..dictionary import merge
from ..kernels.lut_gather import BoundLut, take_small
from ..ops.sort import SortOrder, sort_table
from ..schema import TupleSchema
from ..types import DataType, from_carrier, is_variable_length, to_carrier
from . import file_io

MERGE_CHUNK_ROWS = file_io.MAX_CHUNK_ROWS

# bytes of run files written and read back since the last
# reset_disk_bytes() (what a spill costs in disk traffic)
disk_bytes: dict[str, int] = {"written": 0, "read": 0}


def reset_disk_bytes() -> None:
    for k in disk_bytes:
        disk_bytes[k] = 0


def _host_code_lanes(vals: np.ndarray, valid: Optional[np.ndarray],
                     type_: DataType, asc: bool) -> list:
    """uint64 code lanes of one sort key over host values of its physical
    dtype: their ascending lexicographic order is the key's order, NULL
    equal to NULL, first ascending and last descending, -0.0 equal to
    +0.0, NaN last in the ascending order."""
    one63 = np.uint64(1 << 63)
    if type_ in (DataType.FLOAT, DataType.DOUBLE):
        f = vals.astype(np.float64, copy=True)
        f[f == 0] = 0.0  # -0.0 -> +0.0
        bits = f.view(np.uint64)
        code = np.where(bits >> np.uint64(63) == 1, ~bits, bits | one63)
    elif type_ == DataType.UINT64:
        code = vals.astype(np.uint64)
    else:  # signed ints, UINT32 and BOOL widened, dates, codes
        code = vals.astype(np.int64).view(np.uint64) ^ one63
    lanes = []
    if valid is not None:
        code = np.where(valid, code, np.uint64(0))
        lanes.append((valid if asc else ~valid).astype(np.uint64))
    if not asc:
        code = ~code
    lanes.append(code)
    return lanes


class _Rev:
    """Order-reversing comparison wrapper for DESC keys."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def _row_key(order: SortOrder, schema: TupleSchema):
    """Python row key of the ``heapq`` route: NULL equal to NULL, first
    ascending and last descending (sort.cc:44-47)."""
    idx = [(schema.names().index(k.name), k.ascending) for k in order.keys]

    def key(row):
        parts = []
        for i, asc in idx:
            v = row[i]
            if asc:
                parts.append((0, 0) if v is None else (1, v))
            else:
                parts.append((1, 0) if v is None else (0, _Rev(v)))
        return tuple(parts)

    return key


def _iter_rows(path: str) -> Iterator[tuple]:
    disk_bytes["read"] += os.path.getsize(path)
    for chunk in file_io.iter_chunks(path, device="cpu"):
        yield from chunk.to_pylist()


def _host_arrays(table: Table, schema: TupleSchema):
    """{name: (values of the physical dtype, valid or None)} of the live
    rows, one copy a column to the host."""
    n = int(tracing.to_host(table.num_rows, "spill.num_rows"))
    out = {}
    for a in schema:
        c = table.columns[a.name]
        vals = tracing.to_host(c.values[:n], "spill.values").numpy()
        out[a.name] = (from_carrier(vals, a.type),
                       None if c.valid is None else
                       tracing.to_host(c.valid[:n], "spill.valid").numpy())
    return out


class ExternalSorter:
    """Memory-bounded sorter: feed tables or rows, read the sorted rows
    back (reference: Sorter, sort.h:134-173).

    ``memory_limit_rows`` plays the reference's ``buffer_memory_limit``
    (sort.h:89-98): once that many rows are buffered, they are sorted on
    the device and spilled as a run file.  ``device`` is where the runs
    sort: by default the device of the first table written, or the card
    for rows fed by ``write_rows``."""

    def __init__(self, schema: TupleSchema, order: SortOrder | Sequence,
                 memory_limit_rows: int = 1 << 20,
                 temporary_directory_prefix: Optional[str] = None, *,
                 device=None):
        self.schema = schema
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        for k in self.order.keys:
            schema.lookup(k.name)
        self.limit = max(int(memory_limit_rows), 1)
        self.device = None if device is None else torch.device(device)
        self._tmpdir = tempfile.mkdtemp(prefix="sstp_sort_",
                                        dir=temporary_directory_prefix)
        self._runs: list[str] = []
        self._buffer: list[dict] = []
        self._raw: list[tuple] = []
        self._buffered = 0

    # -- write side (reference: SorterSink) ---------------------------------
    def write(self, table: Table) -> None:
        """Feed a Table's live rows.  They stay on the table's device (its
        column slices) until their run sorts; STRING/BINARY columns keep
        their codes, and the dictionaries merge when the run is built."""
        n = int(tracing.to_host(table.num_rows, "spill.num_rows"))
        if n == 0:
            return
        if self.device is None:
            self.device = table.device
        piece = {a.name: (table.columns[a.name].values[:n],
                          None if table.columns[a.name].valid is None
                          else table.columns[a.name].valid[:n])
                 for a in self.schema}
        self.write_arrays(piece, dict(table.dicts), n)

    def write_arrays(self, cols: dict, dicts: dict, n: int) -> None:
        """Raw feed: ``cols[name] = (values, valid or None)`` of ``n``
        rows, host arrays of the physical dtype or tensors as a table holds
        them; ``dicts`` holds the Dictionary of each STRING/BINARY
        column."""
        if n == 0:
            return
        self._raw.append((n, cols, dicts))
        self._buffered += n
        if self._buffered >= self.limit:
            self._flush()

    def write_rows(self, data: dict) -> None:
        """Feed rows as Python values (None = NULL), a list a column."""
        self._buffer.append({n: list(data[n]) for n in self.schema.names()})
        self._buffered += len(next(iter(data.values()))) if data else 0
        if self._buffered >= self.limit:
            self._flush()

    def _device(self) -> torch.device:
        if self.device is None:
            self.device = torch.device("cuda")
        return self.device

    def _lane(self, x, type_: DataType) -> torch.Tensor:
        """A piece's lane on the sorter's device, in the table's carrier."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(to_carrier(x, type_)))
        return x.to(self._device())

    def _buffer_table(self) -> Optional[Table]:
        if not self._buffered:
            return None
        dev = self._device()
        tables: list[Table] = []
        if self._raw:
            # merge the pieces' dictionaries; pieces that share one
            # dictionary object (pieces of one table) keep their codes
            merged_dicts: dict = {}
            remaps: list[dict] = [dict() for _ in self._raw]
            for a in self.schema:
                if not is_variable_length(a.type):
                    continue
                base = self._raw[0][2][a.name]
                maps: list = [None]
                for _, _, dicts in self._raw[1:]:
                    d = dicts[a.name]
                    if d is base and all(m is None for m in maps):
                        maps.append(None)
                        continue
                    base, ra, rb = merge(base, d)
                    maps = [ra if m is None else ra[m] for m in maps]
                    maps.append(rb)
                merged_dicts[a.name] = base
                for i, m in enumerate(maps):
                    if m is not None:
                        remaps[i][a.name] = m
            total = sum(n for n, _, _ in self._raw)
            cols: dict = {}
            for a in self.schema:
                vparts, vldparts = [], []
                for i, (n, piece, _) in enumerate(self._raw):
                    v, vld = piece[a.name]
                    v = self._lane(v, a.type)
                    if a.name in remaps[i]:
                        v = take_small(BoundLut(remaps[i][a.name]), v)
                    vparts.append(v)
                    if a.nullable:
                        vldparts.append(
                            torch.ones(n, dtype=torch.bool, device=dev)
                            if vld is None else self._lane(vld, DataType.BOOL))
                cols[a.name] = Column(torch.cat(vparts),
                                      torch.cat(vldparts) if a.nullable
                                      else None)
            tables.append(Table(self.schema, cols, total, dev, merged_dicts))
        if self._buffer:
            merged = {n: [] for n in self.schema.names()}
            for part in self._buffer:
                for n in merged:
                    merged[n].extend(part[n])
            tables.append(Table.from_data(self.schema, merged, device=dev))
        if len(tables) == 1:
            return tables[0]
        return concat_tables(tables)

    def _take_buffer(self) -> Optional[Table]:
        t = self._buffer_table()
        self._buffer, self._raw, self._buffered = [], [], 0
        return t

    def _flush(self) -> None:
        t = self._take_buffer()
        if t is None:
            return
        path = os.path.join(self._tmpdir, f"run_{len(self._runs)}.sst")
        file_io.save(path, sort_table(t, self.order))
        disk_bytes["written"] += os.path.getsize(path)
        self._runs.append(path)

    # -- read side (reference: Sorter::GetResultCursor) ---------------------
    def result_chunks(self) -> Iterator[Table]:
        """The sorted rows as Tables of at most 8192 rows: a ``heapq``
        merge of the run files' rows and the last in-memory run
        (sort.cc:366-392)."""
        last = self._take_buffer()
        if not self._runs:
            if last is not None:
                yield sort_table(last, self.order)
            return
        streams = [_iter_rows(p) for p in self._runs]
        if last is not None:
            streams.append(iter(sort_table(last, self.order).to_pylist()))
        key = _row_key(self.order, self.schema)
        names = self.schema.names()
        dev = self._device()
        buf: list[tuple] = []
        for row in heapq.merge(*streams, key=key):
            buf.append(row)
            if len(buf) >= MERGE_CHUNK_ROWS:
                yield Table.from_data(
                    self.schema, {n: [r[i] for r in buf]
                                  for i, n in enumerate(names)}, device=dev)
                buf = []
        if buf:
            yield Table.from_data(
                self.schema, {n: [r[i] for r in buf]
                              for i, n in enumerate(names)}, device=dev)

    def result(self, capacity: Optional[int] = None) -> Table:
        """The whole sorted result as one Table on the sorter's device:
        the C++ k-way merge of code lanes when the library is built and a
        run spilled, else the ``heapq`` route."""
        t = self._native_result(capacity)
        if t is not None:
            return t
        chunks = list(self.result_chunks())
        if not chunks:
            return Table.empty(self.schema, device=self._device())
        if len(chunks) == 1:
            return chunks[0]
        names = self.schema.names()
        merged: dict[str, list] = {n: [] for n in names}
        for c in chunks:
            cols = c.to_numpy()
            for n in names:
                merged[n].extend(list(cols[n]))
        return Table.from_data(self.schema, merged, capacity=capacity,
                               device=self._device())

    def _native_result(self, capacity: Optional[int]) -> Optional[Table]:
        if not native.available() or not self._runs:
            return None
        last = self._take_buffer()
        runs = []  # (host arrays, dicts, rows) of each run
        for p in self._runs:
            disk_bytes["read"] += os.path.getsize(p)
            with open(p, "rb") as f:
                _, values, valids, dicts, n = file_io.read_arrays(f)
            runs.append(({a.name: (values[a.name], valids[a.name]
                                   if a.nullable else None)
                          for a in self.schema}, dicts, n))
        if last is not None:
            t = sort_table(last, self.order)
            runs.append((_host_arrays(t, self.schema), t.dicts,
                         int(tracing.to_host(t.num_rows, "spill.num_rows"))))
        starts = np.zeros(len(runs) + 1, dtype=np.int64)
        np.cumsum([n for _, _, n in runs], out=starts[1:])
        total = int(starts[-1])
        if total == 0:
            return Table.empty(self.schema, device=self._device())
        # one dictionary space a STRING/BINARY column across the runs
        values: dict = {}
        merged_dicts: dict = {}
        for a in self.schema:
            parts = [cols[a.name][0] for cols, _, _ in runs]
            if is_variable_length(a.type):
                d0 = runs[0][1][a.name]
                maps: list = [None]  # None: identity
                for _, dicts, _ in runs[1:]:
                    d0, r_old, r_new = merge(d0, dicts[a.name])
                    maps = [r_old if m is None else r_old[m] for m in maps]
                    maps.append(r_new)
                parts = [v if m is None else m[np.clip(v, 0, len(m) - 1)]
                         for v, m in zip(parts, maps)]
                merged_dicts[a.name] = d0
            values[a.name] = np.concatenate(parts)
        valids = {a.name: None if not a.nullable else np.concatenate(
            [np.ones(n, bool) if cols[a.name][1] is None else cols[a.name][1]
             for cols, _, n in runs]) for a in self.schema}
        lanes: list = []
        for k in self.order.keys:
            a = self.schema.lookup(k.name)
            lanes.extend(_host_code_lanes(values[a.name], valids[a.name],
                                          a.type, k.ascending))
        order = native.kway_merge(np.column_stack(lanes), starts)
        if order is None:
            return None
        return Table.from_arrays(
            self.schema, {n: v[order] for n, v in values.items()},
            {n: None if v is None else v[order] for n, v in valids.items()},
            total, merged_dicts, capacity=capacity, device=self._device())

    def close(self) -> None:
        """Remove the run files and their directory."""
        for p in self._runs:
            try:
                os.unlink(p)
            except OSError:
                pass
        try:
            os.rmdir(self._tmpdir)
        except OSError:
            pass
        self._runs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def external_sort(tables, order, memory_limit_rows: int = 1 << 20,
                  temporary_directory_prefix: Optional[str] = None) -> Table:
    """Sort an iterable of same-schema Tables under a row-count memory
    bound, spilling runs to disk as needed; the result lies on the first
    table's device."""
    sorter = None
    try:
        for t in tables:
            if sorter is None:
                sorter = ExternalSorter(t.schema, order, memory_limit_rows,
                                        temporary_directory_prefix)
            sorter.write(t)
        if sorter is None:
            raise ValueError("external_sort needs at least one table")
        return sorter.result()
    finally:
        if sorter is not None:
            sorter.close()
