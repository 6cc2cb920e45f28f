"""The port's IO against the JAX package's: the columnar file formats (the
same bytes from either package, each package reading the other's files,
over all 13 types with NULLs), ``Table.from_arrays``/``empty`` and
``concat_tables``, and expression deserialization from dicts, JSON and
protobuf wire bytes (the cases of tests/test_io_bench.py).  Tables are
built on the CPU from the same seeded numpy arrays; plans run in both
packages and must give the same rows."""
from __future__ import annotations

import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu.io import file_io as JF
from supersonic_tpu_torch.io import file_io as TF
from torch_parity import bit_rows, schema

torch.set_num_threads(1)

ALL_TYPES = ("INT32", "INT64", "UINT32", "UINT64", "FLOAT", "DOUBLE", "BOOL",
             "DATE", "DATETIME", "STRING", "BINARY", "ENUM", "DATA_TYPE")
ENUM_NAMES = ("RED", "GREEN", "BLUE", "CYAN", "PINK")


def _all_types_data(n, seed=0):
    """(cols, values, valids, JAX dicts, port dicts) of one nullable column
    of each type: NaNs and -0.0 among the floats, UINT32 and UINT64 values
    past 2^31 and 2^63, empty strings, and a fifth of the rows NULL."""
    rng = np.random.default_rng(seed)
    cols, values, valids, jd, td = [], {}, {}, {}, {}
    for i, t in enumerate(ALL_TYPES):
        name = f"c{i}"
        cols.append((name, t, True))
        if t in ("STRING", "BINARY"):
            words = sorted({"", "a", "ab", "été"}
                           | {f"w{k}" for k in range(40)})
            if t == "BINARY":
                words = sorted(w.encode() for w in words) + [b"\x00\xff"]
                words = sorted(words)
            v = rng.integers(0, len(words), n).astype(np.int32)
            jd[name] = J.Dictionary(tuple(words))
            td[name] = T.Dictionary(tuple(words))
        elif t in ("ENUM", "DATA_TYPE"):
            v = rng.integers(0, 5, n).astype(np.int32)
        elif t == "BOOL":
            v = rng.random(n) > 0.5
        elif t in ("FLOAT", "DOUBLE"):
            v = rng.standard_normal(n).astype(
                np.float32 if t == "FLOAT" else np.float64)
            v[::7] = np.nan
            v[1::7] = -0.0
            v[2::11] = -np.inf
        elif t == "UINT32":
            v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        elif t == "UINT64":
            v = rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2) + \
                np.uint64(1)
        elif t in ("INT64", "DATETIME"):
            v = rng.integers(-2**62, 2**62, n)
        else:
            v = rng.integers(-2**31, 2**31, n).astype(np.int32)
        values[name] = v
        valids[name] = rng.random(n) > 0.2
    return cols, values, valids, jd, td


def _pair(cols, values, valids, jd, td, n, enums=None):
    js = schema(J, cols, enums)
    ts = schema(T, cols, enums)
    return (J.Table.from_arrays(js, values, valids, n, jd),
            T.Table.from_arrays(ts, values, valids, n, td, device="cpu"))


def _enums(cols):
    return {n: ENUM_NAMES for n, t, _ in cols if t == "ENUM"}


@pytest.mark.parametrize("n", [0, 3, 20000])
def test_files_are_byte_equal_and_cross_read_over_every_type(n):
    """Either package's file of the same table has the same bytes, and each
    reads the other's to the table's rows (values bit for bit, NULLs)."""
    cols, values, valids, jd, td = _all_types_data(n)
    jt, tt = _pair(cols, values, valids, jd, td, n, _enums(cols))
    jb, tb = io.BytesIO(), io.BytesIO()
    JF.write_table(jb, jt)
    TF.write_table(tb, tt)
    assert jb.getvalue() == tb.getvalue()
    want = bit_rows(jt.to_pylist())
    port_read = TF.read_table(io.BytesIO(jb.getvalue()), device="cpu")
    jax_read = JF.read_table(io.BytesIO(tb.getvalue()))
    assert bit_rows(port_read.to_pylist()) == want
    assert bit_rows(jax_read.to_pylist()) == want
    assert [(a.name, a.type.value, a.nullable) for a in port_read.schema] == \
        [(a.name, a.type.value, a.nullable) for a in jt.schema]
    assert port_read.device == torch.device("cpu")


def test_reference_format_is_byte_equal_and_cross_read(tmp_path):
    """The reference engine's FileSink format: equal bytes over every type
    (BOOL as bytes, uint64 lengths), and each package reads the other's
    file (its reader, like the JAX package's, takes 12 types: no
    DATA_TYPE)."""
    n = 9000
    cols, values, valids, jd, td = _all_types_data(n, seed=1)
    jt, tt = _pair(cols, values, valids, jd, td, n, _enums(cols))
    JF.write_reference_file(jt, str(tmp_path / "j.bin"))
    TF.write_reference_file(tt, str(tmp_path / "t.bin"))
    assert (tmp_path / "j.bin").read_bytes() == \
        (tmp_path / "t.bin").read_bytes()
    readable = [c for c in cols if c[1] != "DATA_TYPE"]
    sub = {n_: values[n_] for n_, _, _ in readable}
    jt2, _ = _pair(readable, sub, valids, jd, td, n, _enums(readable))
    JF.write_reference_file(jt2, str(tmp_path / "j2.bin"))
    got = TF.read_reference_file(schema(T, readable, _enums(readable)),
                                 str(tmp_path / "j2.bin"), device="cpu")
    back = J.io.file_io.read_reference_file(
        schema(J, readable, _enums(readable)), str(tmp_path / "j2.bin"))
    assert bit_rows(got.to_pylist()) == bit_rows(back.to_pylist()) == \
        bit_rows(jt2.to_pylist())


def test_unsigned_columns_are_written_in_their_own_widths(tmp_path):
    """UINT32 goes to disk as 4 bytes and UINT64 as 8, whatever lane the
    port keeps on the device, and values past 2^31 and 2^63 survive."""
    u32 = np.array([0, 2**31 + 5, 2**32 - 1], dtype=np.uint32)
    u64 = np.array([1, 2**63 + 7, 2**64 - 1], dtype=np.uint64)
    cols = (("a", "UINT32", False), ("b", "UINT64", False))
    t = T.Table.from_arrays(schema(T, cols), {"a": u32, "b": u64}, {}, 3,
                            device="cpu")
    T.io.save(str(tmp_path / "u.sst"), t)
    raw = (tmp_path / "u.sst").read_bytes()
    assert u32.tobytes() + u64.tobytes() in raw
    back = J.io.load(str(tmp_path / "u.sst"))
    assert back.to_pylist() == t.to_pylist() == list(
        zip(u32.tolist(), u64.tolist()))


def _small(ns):
    """tests/test_io_bench.py's table."""
    kw = {} if ns is J else {"device": "cpu"}
    return ns.Table.from_data(
        ns.TupleSchema.of(("a", ns.INT64), ("b", ns.DOUBLE),
                          ("s", ns.STRING)),
        {"a": [1, None, 3], "b": [1.5, 2.5, None], "s": ["x", None, "yy"]},
        **kw)


@pytest.mark.parametrize("rows", [3, 20000])
def test_file_roundtrip(rows):
    if rows == 3:
        t = _small(T)
    else:
        t = T.Table.from_data(T.TupleSchema.of(("a", T.INT64, False)),
                              {"a": np.arange(rows)}, device="cpu")
    buf = io.BytesIO()
    T.io.write_table(buf, t)
    buf.seek(0)
    back = T.io.read_table(buf, device="cpu")
    assert back.to_pylist() == t.to_pylist()
    assert back.schema == t.schema


def test_file_io_large_fast_path(tmp_path):
    """200k rows with strings through save and load in well under the JAX
    package's 20 s bound (the C++ gather and encoder, no per-row Python),
    read by the JAX package too."""
    import time

    n = 200_000
    rng = np.random.default_rng(7)
    svals = [f"key_{i % 997}" if i % 11 else None for i in range(n)]
    t = T.Table.from_data(
        T.TupleSchema.of(("k", T.INT64, False), ("s", T.STRING, True),
                         ("v", T.DOUBLE, True)),
        {"k": np.arange(n, dtype=np.int64), "s": svals, "v": rng.random(n)},
        device="cpu")
    p = str(tmp_path / "big.sst")
    t0 = time.perf_counter()
    T.io.save(p, t)
    out = T.io.load(p, device="cpu")
    assert time.perf_counter() - t0 < 20.0
    got = out.to_numpy()
    assert list(got["s"][:22]) == svals[:22]
    assert np.array_equal(got["k"], np.arange(n, dtype=np.int64))
    back = J.io.load(p).to_numpy()
    assert list(back["s"]) == list(got["s"])
    assert np.array_equal(back["v"].astype(float), got["v"].astype(float))


def test_enum_and_binary_roundtrip(tmp_path):
    e = T.EnumDefinition(("RED", "GREEN", "BLUE"))
    s = T.TupleSchema([T.Attribute("c", T.ENUM, True, e),
                       T.Attribute("n", T.INT32, False),
                       T.Attribute("b", T.BINARY, True)])
    t = T.Table.from_data(s, {"c": ["BLUE", None, "RED"], "n": [1, 2, 3],
                              "b": [b"\x00\xff", None, b""]}, device="cpu")
    T.io.save(str(tmp_path / "e.sst"), t)
    assert T.io.load(str(tmp_path / "e.sst"), device="cpu").to_pylist() == \
        [("BLUE", 1, b"\x00\xff"), (None, 2, None), ("RED", 3, b"")]


def test_iter_chunks_streams_the_file(tmp_path):
    n = 20000
    t = T.Table.from_data(T.TupleSchema.of(("a", T.INT64, False),
                                           ("s", T.STRING, True)),
                          {"a": np.arange(n),
                           "s": [None if i % 5 == 0 else f"k{i % 13}"
                                 for i in range(n)]}, device="cpu")
    T.io.save(str(tmp_path / "c.sst"), t)
    chunks = list(TF.iter_chunks(str(tmp_path / "c.sst"), device="cpu"))
    assert [int(c.num_rows) for c in chunks] == [8192, 8192, 3616]
    assert [r for c in chunks for r in c.to_pylist()] == t.to_pylist()


def test_from_arrays_and_empty_match_jax():
    cols = (("x", "INT64", True), ("y", "DOUBLE", False), ("u", "UINT32",
                                                           False))
    values = {"x": np.array([1, 2, 3]), "y": np.array([0.5, 1.5, 2.5]),
              "u": np.array([1, 2**31 + 1, 2**32 - 1], dtype=np.uint32)}
    valids = {"x": np.array([True, False, True]), "y": None}
    got = T.Table.from_arrays(schema(T, cols), values, valids, 3,
                              capacity=8, device="cpu")
    want = J.Table.from_arrays(schema(J, cols), values, valids, 3,
                               capacity=8)
    assert got.capacity == want.capacity == 8
    assert got.to_pylist() == want.to_pylist()
    with pytest.raises(T.SchemaError, match="NULL in non-nullable"):
        T.Table.from_arrays(schema(T, cols), values,
                            {"y": np.array([True, False, True])}, 3,
                            device="cpu")
    with pytest.raises(T.SchemaError, match="num_rows"):
        T.Table.from_arrays(schema(T, cols), values, valids, 4,
                            device="cpu")
    empty = T.Table.empty(schema(T, cols), 5, device="cpu")
    assert (empty.capacity, int(empty.num_rows)) == (5, 0)
    assert empty.to_pylist() == J.Table.empty(schema(J, cols), 5).to_pylist()


def test_concat_tables_merges_dicts():
    """tests/test_batch.py::test_concat_tables_merges_dicts, then padded
    tables of other dictionaries, a nullable column in one table only, and
    the JAX package's rows."""
    s = T.TupleSchema.of(("s", T.STRING),)
    t1 = T.Table.from_data(s, {"s": ["b", "a"]}, device="cpu")
    t2 = T.Table.from_data(s, {"s": ["c", "a", None]}, device="cpu")
    out = T.concat_tables([t1, t2])
    assert out.to_pylist() == [("b",), ("a",), ("c",), ("a",), (None,)]
    assert list(out.dicts["s"].values) == ["a", "b", "c"]

    def tabs(ns):
        kw = {} if ns is J else {"device": "cpu"}
        a = ns.Table.from_data(
            ns.TupleSchema.of(("k", ns.INT64, False), ("w", ns.STRING)),
            {"k": [1, 2, 3], "w": ["z", None, "x"]}, capacity=6, **kw)
        b = ns.Table.from_data(
            ns.TupleSchema.of(("k", ns.INT64, True), ("w", ns.STRING)),
            {"k": [None, 5], "w": ["y", "z"]}, capacity=4, **kw)
        return [a, b, a]

    got, want = T.concat_tables(tabs(T)), J.concat_tables(tabs(J))
    assert got.to_pylist() == want.to_pylist()
    assert got.dicts["w"].values == want.dicts["w"].values
    assert [a.nullable for a in got.schema] == \
        [a.nullable for a in want.schema] == [True, True]
    assert got.capacity == want.capacity == 16


# --- expressions from dicts, JSON and protobuf ---------------------------


def _compute(ns, expr):
    return ns.execute(ns.Compute(expr, ns.ScanTable(_small(ns)))).to_pylist()


def _same(make):
    """make(ns) builds an expression in either package: the port's rows
    equal the JAX package's."""
    got, want = _compute(T, make(T)), _compute(J, make(J))
    assert bit_rows(got) == bit_rows(want)
    return got


DICT_CASES = {
    "add": {"operation": {"id": "ADD", "args": [
        {"variable": "a"}, {"constant": {"type": "INT64", "value": 10}}]}},
    "nested": {"operation": {"id": "IF", "args": [
        {"operation": {"id": "LESS", "args": [
            {"variable": "a"},
            {"constant": {"type": "INT64", "value": 2}}]}},
        {"constant": {"type": "STRING", "value": "low"}},
        {"constant": {"type": "STRING", "value": "high"}}]}},
    "cast": {"operation": {"id": "CAST", "to_type": "DOUBLE",
                           "args": [{"variable": "a"}]}},
    "null": {"operation": {"id": "IF_NULL", "args": [
        {"variable": "b"}, {"constant": {"type": "DOUBLE"}}]}},
}


@pytest.mark.parametrize("case", sorted(DICT_CASES))
def test_build_expression_matches_jax(case):
    import json

    desc = DICT_CASES[case]
    rows = _same(lambda ns: ns.io.build_expression(desc))
    assert _compute(T, T.io.build_expression_from_json(json.dumps(desc))) \
        == rows
    if case == "nested":
        assert [r[0] for r in rows] == ["low", "high", "high"]


def test_build_sort_order_and_aggregation():
    order = T.io.build_sort_order([{"column": "a", "ascending": False}])
    out = T.execute(T.Sort(order, T.ScanTable(_small(T))))
    assert [r[0] for r in out.to_pylist()] == [3, 1, None]
    spec = T.io.build_aggregation([
        {"aggregation": "SUM", "input": "a", "output": "sa"},
        {"aggregation": "COUNT", "output": "c"}])
    out2 = T.execute(T.GroupAggregate(["s"], spec, T.ScanTable(_small(T))))
    assert sorted(out2.to_pylist(), key=str) == sorted(
        [("x", 1, 1), (None, None, 1), ("yy", 3, 1)], key=str)


def _pb():
    from supersonic_tpu_torch.io import expressions_pb2
    return expressions_pb2


def _var(name):
    d = _pb().ExpressionDescription(type=_pb().VARIABLE)
    d.variable.name = name
    return d


def _const(field, type_, value):
    d = _pb().ExpressionDescription(type=_pb().CONSTANT)
    d.constant.type = type_
    setattr(d.constant, field, value)
    return d


def _op(op_type, *args):
    d = _pb().ExpressionDescription(type=_pb().OPERATION)
    d.operation.type = op_type
    for a in args:
        d.operation.argument.add().CopyFrom(a)
    return d


def _proto_cases():
    pb = _pb()
    i64 = lambda v: _const("int64_value", pb.INT64, v)  # noqa: E731
    type_const = pb.ExpressionDescription(type=pb.CONSTANT)
    type_const.constant.type = pb.DATA_TYPE
    type_const.constant.data_type_value = pb.DOUBLE
    null = pb.ExpressionDescription(type=pb.CONSTANT)
    null.constant.type = pb.INT64
    path = pb.ExpressionDescription(type=pb.PATH)
    path.path.node.append("b")
    tup = pb.ExpressionDescription(type=pb.TUPLE)
    e1 = tup.tuple.expression.add()
    e1.expression.CopyFrom(_op(pb.ADD, _var("a"), i64(1)))
    e1.alias.append("a1")
    e2 = tup.tuple.expression.add()
    e2.expression.CopyFrom(_var("s"))
    e2.alias.append("s2")
    return {
        "wire": _op(pb.MULTIPLY, _op(pb.ADD, _var("a"), i64(5)), _var("a")),
        "cast": _op(pb.CAST, type_const, _var("a")),
        "typed_null": null,
        "case": _op(pb.CASE, _var("a"), i64(99), i64(1), i64(10)),
        "in": _op(pb.IN, _var("a"), i64(1), i64(3)),
        "regexp": _op(pb.REGEXP_PARTIAL, _var("s"),
                      _const("string_value", pb.STRING, "y+")),
        "tuple": tup,
        "path": path,
        "pi": _op(pb.PI),
        "tostring": _op(pb.TOSTRING, _var("s")),
    }


@pytest.mark.parametrize("case", ["wire", "cast", "typed_null", "case", "in",
                                  "regexp", "tuple", "path", "pi",
                                  "tostring"])
def test_proto_expression_matches_jax(case):
    """The same serialized ExpressionDescription bytes through both
    packages' ``build_expression_from_proto_bytes`` give the same rows (a
    TUPLE gives aliased expressions for Compute)."""
    wire = _proto_cases()[case].SerializeToString()
    _same(lambda ns: ns.io.build_expression_from_proto_bytes(wire))


def test_proto_errors_and_custom_function():
    pb = _pb()
    from supersonic_tpu_torch.io import (SerializationError,
                                         build_expression_from_proto,
                                         register_function)
    with pytest.raises(SerializationError):  # unimplemented in ref too
        build_expression_from_proto(_op(pb.DATEDIFF, _var("a"), _var("a")))
    with pytest.raises(SerializationError):  # host-side divergence
        build_expression_from_proto(_op(pb.DATE_FORMAT_UTC, _var("a")))
    fd = pb.ExpressionDescription(type=pb.CUSTOM_FUNCTION_CALL)
    fd.function_call.function_name = "port_double_it"
    fd.function_call.argument.add().CopyFrom(_var("a"))
    with pytest.raises(SerializationError):
        build_expression_from_proto(fd)
    register_function("port_double_it",
                      lambda e: T.Multiply(e, T.ConstInt64(2)))
    assert [r[0] for r in _compute(T, build_expression_from_proto(fd))] == \
        [2, None, 6]


def test_both_protobuf_modules_share_one_descriptor():
    """The port's expressions_pb2 is the JAX package's byte for byte, so
    both register one expressions.proto in protobuf's default pool."""
    from supersonic_tpu.io import expressions_pb2 as jpb
    from supersonic_tpu_torch.io import expressions_pb2 as tpb

    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tpb.ExpressionDescription.DESCRIPTOR.full_name == \
        "supersonic_tpu.ExpressionDescription"


def test_import_leaves_protobuf_out():
    code = ("import sys, supersonic_tpu_torch, supersonic_tpu_torch.io, "
            "supersonic_tpu_torch.io.external; "
            "bad = sorted(m for m in sys.modules if m == 'google.protobuf' "
            "or m.startswith('google.protobuf.') or m.split('.')[0] in "
            "('jax', 'supersonic_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(pathlib.Path(__file__).parent.parent))
    assert res.returncode == 0, res.stdout + res.stderr
