"""Binary columnar file formats (host side).

Port of ``supersonic_tpu/io/file_io.py`` (reference: cursor/infrastructure/
file_io.cc).  Two formats, each byte for byte the JAX package's:

  * the engine's own (``write_table``/``read_table``, ``save``/``load``,
    ``iter_chunks``): a magic word and a schema header, then chunks of at
    most 8192 rows (file_io.cc:33), each a uint32 row count and, per
    column, a byte a row of is_null for a nullable column, then the raw
    fixed-width values (NULL rows zeroed), or for STRING/BINARY uint32
    lengths and the concatenated payloads (file_io.cc:56-101); a
    0xFFFFFFFF count ends the file;
  * the reference engine's FileSink format (``read_reference_file``/
    ``write_reference_file``, file_io.cc:194, 319): no header, a uint64
    row count a chunk, uint64 string lengths, BOOL as bytes.

Values go to disk in their logical types: UINT32 as 4-byte ``uint32`` and
UINT64 as ``uint64`` (``types.from_carrier``), never as the int64 lanes
the port keeps on the device.  A table on the card crosses to the host
once a column, and each column is laid out for the file once; the chunks
are then slices of those buffers.  STRING payloads are gathered and
dictionary-encoded by the port's C++ helpers (``native/fastcol.cpp``),
or by Python loops without a host compiler.  Readers build tables on
``device``, the card unless the caller asks for another.
"""
from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from .. import native
from ..batch import Table
from ..dictionary import Dictionary, encode
from ..schema import Attribute, EnumDefinition, TupleSchema
from ..types import DataType, from_carrier, is_variable_length, physical_dtype

MAX_CHUNK_ROWS = 8192  # reference: file_io.cc:33
MAGIC = b"SSTP1\n"


def _write_schema(f: BinaryIO, schema: TupleSchema) -> None:
    f.write(struct.pack("<I", len(schema)))
    for a in schema:
        name = a.name.encode()
        f.write(struct.pack("<I", len(name)))
        f.write(name)
        t = a.type.value.encode()
        f.write(struct.pack("<I", len(t)))
        f.write(t)
        f.write(struct.pack("<B", 1 if a.nullable else 0))
        if a.type == DataType.ENUM:
            f.write(struct.pack("<I", len(a.enum.names)))
            for nm in a.enum.names:
                b = nm.encode()
                f.write(struct.pack("<I", len(b)))
                f.write(b)


def _read_schema(f: BinaryIO) -> TupleSchema:
    (n,) = struct.unpack("<I", f.read(4))
    attrs = []
    for _ in range(n):
        (ln,) = struct.unpack("<I", f.read(4))
        name = f.read(ln).decode()
        (lt,) = struct.unpack("<I", f.read(4))
        t = DataType(f.read(lt).decode())
        (nullable,) = struct.unpack("<B", f.read(1))
        enum = None
        if t == DataType.ENUM:
            (ne,) = struct.unpack("<I", f.read(4))
            names = []
            for _ in range(ne):
                (le,) = struct.unpack("<I", f.read(4))
                names.append(f.read(le).decode())
            enum = EnumDefinition(tuple(names))
        attrs.append(Attribute(name, t, bool(nullable), enum))
    return TupleSchema(attrs)


def _dict_blob(d: Dictionary, binary: bool):
    """(payload bytes, int64 offsets[len + 1], int64 lengths[len]) of a
    dictionary's values."""
    payloads = [v if binary else v.encode() for v in d.values]
    lengths = np.fromiter((len(p) for p in payloads), dtype=np.int64,
                          count=len(payloads))
    offsets = np.zeros(len(payloads) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return b"".join(payloads), offsets, lengths


class _Column:
    """One column laid out for a file: ``nulls`` (a byte a row, 1 = NULL)
    or None, ``lengths`` (string lengths as bytes) or None, ``data`` (the
    value bytes or the concatenated payloads) and ``ends`` (int64[n + 1]
    byte offsets of the rows in ``data``, for strings) or ``size`` (bytes a
    value)."""

    __slots__ = ("nulls", "lengths", "data", "ends", "size")

    def chunk(self, start: int, stop: int, len_size: int) -> list:
        parts = [] if self.nulls is None else [self.nulls[start:stop]]
        if self.lengths is not None:
            parts.append(self.lengths[start * len_size:stop * len_size])
            parts.append(self.data[self.ends[start]:self.ends[stop]])
        else:
            parts.append(self.data[start * self.size:stop * self.size])
        return parts


def _layout(table: Table, reference: bool) -> tuple[int, list]:
    """The live rows of ``table`` laid out for a file, a ``_Column`` each:
    one host copy a column, NULL values zeroed, STRING payloads gathered
    once.  ``reference``: the FileSink format (uint64 lengths, BOOL as
    bytes, is_null only for nullable columns)."""
    n = int(table.num_rows)
    out = []
    for a in table.schema:
        c = table.columns[a.name]
        vals = from_carrier(c.values[:n].cpu().numpy(), a.type)
        valid = (np.ones(n, dtype=bool) if c.valid is None
                 else c.valid[:n].cpu().numpy())
        col = _Column()
        col.nulls = (memoryview((~valid).astype(np.uint8))
                     if a.nullable else None)
        col.lengths = None
        if is_variable_length(a.type):
            blob, offsets, dlens = _dict_blob(table.dicts[a.name],
                                              a.type == DataType.BINARY)
            codes = np.clip(vals.astype(np.int64), 0, max(len(dlens) - 1, 0))
            lengths = (dlens[codes] if len(dlens)
                       else np.zeros(n, dtype=np.int64))
            lengths = np.where(valid, lengths, 0)
            col.lengths = memoryview(lengths.astype(
                np.uint64 if reference else np.uint32)).cast("B")
            col.ends = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lengths, out=col.ends[1:])
            total = int(col.ends[-1])
            data = native.gather_blob_bytes(blob, offsets,
                                            codes.astype(np.int32), valid,
                                            total)
            if data is None:  # no host compiler: a Python loop
                data = b"".join(blob[offsets[k]:offsets[k + 1]]
                                for k, ok in zip(codes.tolist(),
                                                 valid.tolist()) if ok)
            col.data = memoryview(data)
        else:
            if reference and a.type == DataType.BOOL:
                vals = np.where(valid, vals, False).astype(np.uint8)
            elif a.nullable:
                vals = np.where(valid, vals, np.zeros(1, vals.dtype))
            vals = np.ascontiguousarray(vals)
            col.size = vals.dtype.itemsize
            col.data = memoryview(vals).cast("B")
        out.append(col)
    return n, out


def write_table(f: BinaryIO, table: Table) -> None:
    """Write a Table in the engine's chunked format."""
    f.write(MAGIC)
    _write_schema(f, table.schema)
    n, cols = _layout(table, reference=False)
    for start in range(0, n, MAX_CHUNK_ROWS):
        stop = min(start + MAX_CHUNK_ROWS, n)
        f.write(struct.pack("<I", stop - start))
        for col in cols:
            for part in col.chunk(start, stop, 4):
                f.write(part)
    f.write(struct.pack("<I", 0xFFFFFFFF))  # end marker


def _decode_strings(blobs: list, lengths: np.ndarray, valid: np.ndarray,
                    binary: bool):
    """Every payload of a column -> (int32 codes, sorted Dictionary)."""
    blob = b"".join(blobs)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths.astype(np.int64), out=offsets[1:])
    res = native.dict_encode_bytes(blob, offsets, valid)
    if res is not None:
        codes, dict_rows = res
        offs = offsets.tolist()  # Python ints: numpy scalars index slowly
        vals = [blob[offs[r]:offs[r + 1]] for r in dict_rows.tolist()]
        if not binary:
            vals = [b.decode() for b in vals]
        return codes, Dictionary(tuple(vals))
    out = []  # no host compiler: Python decode, then dictionary.encode
    for i in range(len(lengths)):
        if not valid[i]:
            out.append(None)
            continue
        b = blob[offsets[i]:offsets[i + 1]]
        out.append(b if binary else b.decode())
    codes, _, d = encode(out)
    return codes, d


def _read_chunk_column(f: BinaryIO, a: Attribute, count: int):
    """(values or payload bytes, lengths or None, valid) of one column of
    one chunk of the engine's format."""
    is_null = (np.frombuffer(f.read(count), dtype=np.uint8) if a.nullable
               else np.zeros(count, np.uint8))
    if is_variable_length(a.type):
        lengths = np.frombuffer(f.read(4 * count), dtype=np.uint32)
        return f.read(int(lengths.sum())), lengths, is_null == 0
    dtype = physical_dtype(a.type)
    vals = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
    return vals, None, is_null == 0


def _assemble(schema: TupleSchema, parts: dict):
    """(values, valids, dicts) host arrays of every chunk's parts:
    ``parts[name]`` lists (values or payloads, lengths or None, valid) a
    chunk."""
    values: dict = {}
    valids: dict = {}
    dicts: dict = {}
    for a in schema:
        chunks = parts[a.name]
        valid = (np.concatenate([c[2] for c in chunks]) if chunks
                 else np.zeros(0, dtype=bool))
        if is_variable_length(a.type):
            lengths = (np.concatenate([c[1] for c in chunks]) if chunks
                       else np.zeros(0, np.uint32))
            values[a.name], dicts[a.name] = _decode_strings(
                [c[0] for c in chunks], lengths, valid,
                a.type == DataType.BINARY)
        else:
            values[a.name] = (np.concatenate([c[0] for c in chunks])
                              if chunks
                              else np.zeros(0, physical_dtype(a.type)))
        valids[a.name] = valid
    return values, valids, dicts


def _chunk_counts(f: BinaryIO):
    """The row counts of the engine format's chunks, read as they come."""
    while True:
        raw = f.read(4)
        if len(raw) < 4:
            return
        (count,) = struct.unpack("<I", raw)
        if count == 0xFFFFFFFF:
            return
        yield count


def read_arrays(f: BinaryIO):
    """A file of ``write_table`` as host arrays: (schema, values, valids,
    dicts, row count), values in their physical dtypes (what
    ``Table.from_arrays`` takes)."""
    if f.read(len(MAGIC)) != MAGIC:
        raise IOError("bad file magic")
    schema = _read_schema(f)
    parts: dict = {a.name: [] for a in schema}
    total = 0
    for count in _chunk_counts(f):
        total += count
        for a in schema:
            parts[a.name].append(_read_chunk_column(f, a, count))
    return (schema, *_assemble(schema, parts), total)


def read_table(f: BinaryIO, capacity: int | None = None, *,
               device="cuda") -> Table:
    """Read a Table written by ``write_table`` onto ``device``."""
    schema, values, valids, dicts, total = read_arrays(f)
    return Table.from_arrays(schema, values, valids, total, dicts,
                             capacity=capacity, device=device)


def iter_chunks(path: str, *, device="cuda"):
    """Stream a file's chunks as Tables of at most MAX_CHUNK_ROWS rows
    without loading the whole file (the reading half of the reference's
    spill-run streaming, FileInputCursor, file_io.cc:319).  Each chunk
    carries dictionaries of its own."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise IOError("bad file magic")
        schema = _read_schema(f)
        for count in _chunk_counts(f):
            parts = {a.name: [_read_chunk_column(f, a, count)]
                     for a in schema}
            values, valids, dicts = _assemble(schema, parts)
            yield Table.from_arrays(schema, values, valids, count, dicts,
                                    device=device)


# The reference engine's FileSink/FileInput wire format (file_io.cc:194,
# 319), schema out of band: chunks until EOF, each a uint64 row count and
# per column [nullable: a byte a row of is_null] then fixed-width raw
# values, or uint64 lengths and the concatenated payloads.  These read and
# write the files of refbuild/golden_dump.cc (the goldens).

_FIXED_SIZES = {
    DataType.INT32: 4, DataType.UINT32: 4, DataType.FLOAT: 4,
    DataType.DATE: 4, DataType.INT64: 8, DataType.UINT64: 8,
    DataType.DOUBLE: 8, DataType.DATETIME: 8, DataType.BOOL: 1,
    DataType.ENUM: 4,  # int32 value number (tuple_schema.h:42)
}


def read_reference_file(schema: TupleSchema, path: str,
                        capacity: int | None = None, *,
                        device="cuda") -> Table:
    """Read a file of the reference engine's FileSink (file_io.cc:194)
    given its out-of-band schema, onto ``device``."""
    parts: dict = {a.name: [] for a in schema}
    total = 0
    with open(path, "rb") as f:
        while True:
            raw = f.read(8)
            if len(raw) < 8:
                break
            (count,) = struct.unpack("<Q", raw)
            total += count
            for a in schema:
                valid = (np.frombuffer(f.read(count), dtype=np.uint8) == 0
                         if a.nullable else np.ones(count, dtype=bool))
                if is_variable_length(a.type):
                    lengths = np.frombuffer(f.read(8 * count),
                                            dtype=np.uint64)
                    parts[a.name].append(
                        (f.read(int(lengths.sum())), lengths, valid))
                    continue
                data = f.read(_FIXED_SIZES[a.type] * count)
                if a.type == DataType.BOOL:
                    vals = np.frombuffer(data, dtype=np.uint8) != 0
                else:
                    vals = np.frombuffer(data, dtype=physical_dtype(a.type))
                parts[a.name].append((vals, None, valid))
    values, valids, dicts = _assemble(schema, parts)
    return Table.from_arrays(schema, values, valids, total, dicts,
                             capacity=capacity, device=device)


def write_reference_file(table: Table, path: str) -> None:
    """Write a Table in the reference engine's FileSink format, so its
    FileInputCursor (file_io.cc:319) reads it (schema out of band)."""
    n, cols = _layout(table, reference=True)
    with open(path, "wb") as f:
        for start in range(0, n, MAX_CHUNK_ROWS):
            stop = min(start + MAX_CHUNK_ROWS, n)
            f.write(struct.pack("<Q", stop - start))
            for col in cols:
                for part in col.chunk(start, stop, 8):
                    f.write(part)


def save(path: str, table: Table) -> None:
    with open(path, "wb") as f:
        write_table(f, table)


def load(path: str, capacity: int | None = None, *, device="cuda") -> Table:
    with open(path, "rb") as f:
        return read_table(f, capacity, device=device)
