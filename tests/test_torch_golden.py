"""The port against the real C++ engine's output (the goldens of
tests/test_golden.py): the inputs and outputs are read with the port's own
``read_reference_file``, so these cases need no JAX (one test holds that
reader against the JAX package's over every golden file); the port's plan
must give the C++ engine's rows, compared by tests/test_golden.py's rule
(ordered, every value and NULL exact).

Every golden case of tests/test_golden.py has its port counterpart here,
``proto_expr`` through the port's ``build_expression_from_proto_bytes``.
The group-by and join cases compare ordered by their key, as
tests/test_golden.py does (the row order of a hash group-by or hash join
is the engine's)."""
from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu.io.file_io import read_reference_file
from supersonic_tpu_torch.io import file_io as TF
from supersonic_tpu_torch.io.serialization import (
    build_expression_from_proto_bytes)

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"

pytestmark = pytest.mark.skipif(
    not (GOLDEN / "manifest.txt").exists(),
    reason="golden files not generated (run refbuild/bin/golden_dump)")


def _cols(spec: str):
    """[(name, type name, nullable)] of a manifest schema."""
    out = []
    for part in spec.split(","):
        name, typ, nul = part.rsplit(":", 2)
        out.append((name, typ, nul == "Y"))
    return out


# ENUM value maps are out of band in the reference's file format; these are
# tests/test_golden.py's (refbuild/golden_dump.cc's), by column name
GOLDEN_ENUMS = {"e": ("iron", "zinc", "gold", "lead", "tin")}


def _schema(ns, cols):
    return ns.TupleSchema([
        ns.Attribute(n, getattr(ns.DataType, t), nl,
                     ns.EnumDefinition(GOLDEN_ENUMS[n]) if t == "ENUM"
                     else None) for n, t, nl in cols])


def _manifest(case: str):
    """{"in": [(file, cols)], "out": (file, rows, cols)} of one case."""
    found: dict = {"in": []}
    for line in (GOLDEN / "manifest.txt").read_text().splitlines():
        f = line.split(" ")
        if f[0] == "in" and f[1] == case:
            found["in"].append((f[3], _cols(" ".join(f[5:]))))
        elif f[0] == "out" and f[1] == case:
            found["out"] = (f[2], int(f[3]), _cols(" ".join(f[4:])))
    return found


def _read(f: str, cols) -> "T.Table":
    """A golden file through the port's reader, on the CPU."""
    return TF.read_reference_file(_schema(T, cols), str(GOLDEN / f),
                                  device="cpu")


def _inputs(case: str) -> list:
    return [_read(f, cols) for f, cols in _manifest(case)["in"]]


def _golden_out(case: str):
    f, rows, cols = _manifest(case)["out"]
    t = _read(f, cols)
    assert int(t.num_rows) == rows
    return t


def _files():
    """(file, cols) of every input and output file of the manifest."""
    for line in (GOLDEN / "manifest.txt").read_text().splitlines():
        f = line.split(" ")
        if f[0] == "in":
            yield f[3], _cols(" ".join(f[5:]))
        elif f[0] == "out":
            yield f[2], _cols(" ".join(f[4:]))


def test_both_readers_give_equal_arrays_for_every_golden_file():
    """The port's read_reference_file and the JAX package's read every
    golden file to the same values (bit for bit), NULL masks and
    dictionaries."""
    seen = 0
    for f, cols in _files():
        got = _read(f, cols)
        want = read_reference_file(_schema(J, cols), str(GOLDEN / f))
        n = int(want.num_rows)
        assert int(got.num_rows) == n, f
        for name, typ, _ in cols:
            g, w = got.columns[name], want.columns[name]
            gv = T.types.from_carrier(g.values[:n].numpy(),
                                      getattr(T.DataType, typ))
            wv = np.asarray(w.values)[:n]
            assert gv.dtype == wv.dtype and gv.tobytes() == wv.tobytes(), \
                (f, name)
            gm = np.ones(n, bool) if g.valid is None else g.valid[:n].numpy()
            wm = np.ones(n, bool) if w.valid is None else \
                np.asarray(w.valid)[:n]
            assert np.array_equal(gm, wm), (f, name)
            if name in want.dicts:
                assert got.dicts[name].values == want.dicts[name].values
        seen += 1
    assert seen == len(list((GOLDEN).glob("*.dat")))


def _host_columns(table):
    """(values, validity) per column on the host, strings decoded; as
    tests/test_golden.py::_host_columns."""
    n = int(table.num_rows)
    vals, valids = [], []
    for a in table.schema:
        c = table.columns[a.name]
        v = np.asarray(c.values)[:n]
        ok = (np.ones(n, dtype=bool) if c.valid is None
              else np.asarray(c.valid)[:n].astype(bool))
        if a.type.value in ("STRING", "BINARY"):
            d = table.dicts[a.name]
            payloads = np.array(list(d.values) + [""], dtype=object)
            codes = np.clip(v.astype(np.int64), 0, len(d.values))
            v = payloads[np.where(ok, codes, len(d.values))]
        vals.append(v)
        valids.append(ok)
    return vals, valids


def assert_tables_match(actual, golden, sort_by=None, float_rtol=0.0):
    """tests/test_golden.py:120-160's comparison: positional columns, the
    reference's types and nullability, NULL masks and values exact.
    ``sort_by``: positions of exactly typed columns forming a unique row
    key, by which both sides are ordered first (for a group-by, whose row
    order is the engine's); ``float_rtol`` > 0 allows that relative error
    on FLOAT/DOUBLE values (summation order)."""
    assert len(actual.schema) == len(golden.schema)
    assert int(actual.num_rows) == int(golden.num_rows)
    for an, gn in zip(actual.schema, golden.schema):
        assert an.type.value == gn.type.value, \
            f"column {an.name}: {an.type} != reference {gn.type}"
        assert an.nullable == gn.nullable, \
            f"column {an.name}: nullable {an.nullable} != {gn.nullable}"
    a_vals, a_ok = _host_columns(actual)
    g_vals, g_ok = _host_columns(golden)
    if sort_by is None:
        ap = gp = np.arange(int(actual.num_rows))
    else:
        for i in sort_by:
            assert a_ok[i].all() and g_ok[i].all(), "sort_by column has NULLs"
        ap = np.lexsort([a_vals[i] for i in reversed(sort_by)])
        gp = np.lexsort([g_vals[i] for i in reversed(sort_by)])
    for i, name in enumerate(golden.schema.names()):
        am, gm = a_ok[i][ap], g_ok[i][gp]
        np.testing.assert_array_equal(
            am, gm, err_msg=f"null mask mismatch in column {name}")
        av, gv = a_vals[i][ap][am], g_vals[i][gp][gm]
        if float_rtol > 0 and golden.schema.attribute(i).type.value in (
                "FLOAT", "DOUBLE"):
            np.testing.assert_allclose(
                av.astype(np.float64), gv.astype(np.float64),
                rtol=float_rtol, atol=0.0,
                err_msg=f"value mismatch in column {name}")
        else:
            np.testing.assert_array_equal(
                av, gv, err_msg=f"value mismatch in column {name}")


def test_golden_guide_sort():
    (t,) = _inputs("guide_sort")
    out = T.execute(T.Sort([T.SortKey("grade", ascending=False),
                            T.SortKey("id", ascending=True)], T.ScanTable(t)))
    assert_tables_match(out, _golden_out("guide_sort"))


def test_golden_filter_null():
    """A nullable INT32 filter (NULL counts as false) carrying DOUBLE and
    STRING columns through the compaction."""
    (t,) = _inputs("filter_null")
    out = T.execute(T.Filter(T.Greater(T.col("a"), T.ConstInt32(50)),
                             T.ScanTable(t)))
    assert_tables_match(out, _golden_out("filter_null"))


def _bench_sort_keys(ns):
    return [ns.SortKey("col0", ascending=True),
            ns.SortKey("col1", ascending=False)]


def test_golden_bench_sort():
    (t,) = _inputs("bench_sort")
    out = T.execute(T.Sort(_bench_sort_keys(T), T.ScanTable(t)))
    assert_tables_match(out, _golden_out("bench_sort"))


def test_golden_bench_merge():
    t0, t1 = _inputs("bench_merge")
    out = T.execute(T.MergeUnionAll(
        _bench_sort_keys(T),
        [T.Sort(_bench_sort_keys(T), T.ScanTable(t0)),
         T.Sort(_bench_sort_keys(T), T.ScanTable(t1))]))
    assert_tables_match(out, _golden_out("bench_merge"))


def test_golden_inputs_survive_the_move_into_the_port():
    """The STRING inputs the goldens read come through the port's reader
    with their dictionaries, rows and NULLs as the JAX package reads
    them."""
    for case in ("bench_sort", "bench_merge"):
        for (f, cols), t in zip(_manifest(case)["in"], _inputs(case)):
            jt = read_reference_file(_schema(J, cols), str(GOLDEN / f))
            assert t.to_pylist() == jt.to_pylist()
            assert t.schema.lookup("col1").type == T.STRING


def test_golden_primer_sum():
    """A DOUBLE SUM by an INT32 key: the sort path (64-bit input)."""
    (t,) = _inputs("primer_sum")
    out = T.execute(T.GroupAggregate(
        ["key"], [T.AggSpec(T.Aggregation.SUM, "data", "data_sums")],
        T.ScanTable(t)))
    # DOUBLE SUM: the accumulation order differs from the row-serial C++
    assert_tables_match(out, _golden_out("primer_sum"), sort_by=[0],
                        float_rtol=1e-12)


def test_golden_guide_agg():
    """SUM, MIN, MAX and COUNT of INT32 by a STRING key: dense by the
    dictionary; INT32 SUM wraps exactly, so every value is exact."""
    (t,) = _inputs("guide_agg")
    A = T.Aggregation
    out = T.execute(T.GroupAggregate(
        ["department"],
        [T.AggSpec(A.SUM, "salary", "salary_sum"),
         T.AggSpec(A.MIN, "age", "age_min"),
         T.AggSpec(A.MAX, "age", "age_max"),
         T.AggSpec(A.COUNT, "age", "age_cnt")],
        T.ScanTable(t)))
    assert_tables_match(out, _golden_out("guide_agg"), sort_by=[0])


def test_golden_bench_group():
    """MAX of INT32 by a STRING key of 50 values: dense by the
    dictionary."""
    (t,) = _inputs("bench_group")
    out = T.execute(T.GroupAggregate(
        ["col0"], [T.AggSpec(T.Aggregation.MAX, "col1", "col1_maxes")],
        T.ScanTable(t)))
    assert_tables_match(out, _golden_out("bench_group"), sort_by=[0])


def test_golden_guide_join():
    """A UNIQUE INNER join on an INT32 key (nullable on the probe side)
    carrying a DATE payload; the C++ engine's row order is its own, so the
    rows compare ordered by book_id, as tests/test_golden.py does."""
    authors, books = _inputs("guide_join")
    assert books.schema.lookup("date_published").type == T.DATE
    out = T.execute(T.HashJoin(
        T.JoinType.INNER, ["author_id_ref"], ["author_id"],
        T.ScanTable(books), T.ScanTable(authors), T.KeyUniqueness.UNIQUE,
        lhs_projector=T.Projector.named("book_id", "title", "date_published"),
        rhs_projector=T.Projector.named("name", "nobel")))
    assert_tables_match(out, _golden_out("guide_join"), sort_by=[0])


def test_golden_bench_join():
    """A LEFT_OUTER UNIQUE join on a STRING key against a group-by's
    output: the build side's dictionary is the group-by's, remapped into
    the probe's; ordered by the unique STRING key L.col1."""
    lhs_in, rhs_in = _inputs("bench_join")
    lhs = T.Sort(_bench_sort_keys(T), T.ScanTable(lhs_in))
    rhs = T.GroupAggregate(
        ["col0"], [T.AggSpec(T.Aggregation.MAX, "col1", "col1_maxes")],
        T.ScanTable(rhs_in))
    out = T.execute(T.HashJoin(
        T.JoinType.LEFT_OUTER, ["col1"], ["col0"], lhs, rhs,
        T.KeyUniqueness.UNIQUE,
        lhs_projector=T.Projector([("col0", "L.col0"), ("col1", "L.col1")]),
        rhs_projector=T.Projector([("col0", "R.col0"),
                                   ("col1_maxes", "R.col1_maxes")])))
    assert_tables_match(out, _golden_out("bench_join"), sort_by=[1])


def test_golden_enum_binary():
    """ENUM (compared by value number) and BINARY group keys, both
    nullable (the sort path), an INT64 SUM and a COUNT, then a Sort by the
    two keys."""
    (t,) = _inputs("enum_binary")
    A = T.Aggregation
    out = T.execute(T.Sort(
        [T.SortKey("e"), T.SortKey("b")],
        T.GroupAggregate(["e", "b"], [T.AggSpec(A.SUM, "v", "sv"),
                                      T.AggSpec(A.COUNT, "b", "cb")],
                         T.ScanTable(t))))
    assert_tables_match(out, _golden_out("enum_binary"))


def test_golden_scalar_empty():
    """A ScalarAggregate over an empty input: one row, SUM NULL, COUNT 0."""
    (t,) = _inputs("scalar_empty")
    A = T.Aggregation
    out = T.execute(T.ScalarAggregate(
        [T.AggSpec(A.SUM, "x", "x_sum"), T.AggSpec(A.COUNT, "x", "x_cnt")],
        T.ScanTable(t)))
    assert_tables_match(out, _golden_out("scalar_empty"))


def test_golden_agg_clusters():
    """AggregateClusters: the reference's streaming cluster order, so the
    rows compare in order."""
    (t,) = _inputs("agg_clusters")
    A = T.Aggregation
    out = T.execute(T.AggregateClusters(
        ["k"], [T.AggSpec(A.SUM, "v", "sv"), T.AggSpec(A.MIN, "v", "mn"),
                T.AggSpec(A.COUNT, "v", "c")], T.ScanTable(t)))
    assert_tables_match(out, _golden_out("agg_clusters"))


def test_golden_concat_agg():
    """CONCAT of STRING and INT64 inputs, plain and DISTINCT, beside an
    INT64 SUM: byte for byte, ordered by the key."""
    (t,) = _inputs("concat_agg")
    A = T.Aggregation
    out = T.execute(T.GroupAggregate(
        ["k"], [T.AggSpec(A.CONCAT, "s", "cs"), T.AggSpec(A.CONCAT, "v", "cv"),
                T.AggSpec(A.CONCAT, "s", "csd", distinct=True),
                T.AggSpec(A.SUM, "v", "sv")], T.ScanTable(t)))
    assert_tables_match(out, _golden_out("concat_agg"), sort_by=[0])


def test_golden_concat_float():
    """CONCAT of FLOAT and DOUBLE inputs as SimpleFtoa/SimpleDtoa print
    them ("%.6g"/"%.15g", again at "%.8g"/"%.17g" when they do not round
    trip)."""
    (t,) = _inputs("concat_float")
    A = T.Aggregation
    out = T.execute(T.GroupAggregate(
        ["k"], [T.AggSpec(A.CONCAT, "f", "cf"), T.AggSpec(A.CONCAT, "d", "cd")],
        T.ScanTable(t)))
    assert_tables_match(out, _golden_out("concat_float"), sort_by=[0])


def test_golden_limit():
    (t,) = _inputs("limit")
    out = T.execute(T.Limit(137, 4321, T.ScanTable(t)))
    assert_tables_match(out, _golden_out("limit"))


def test_golden_coalesce():
    t0, t1 = _inputs("coalesce")
    out = T.execute(T.Coalesce(T.ScanTable(t0), T.ScanTable(t1)))
    assert_tables_match(out, _golden_out("coalesce"))


def test_golden_rowid_join():
    left, right = _inputs("rowid_join")
    out = T.execute(T.RowidMergeJoin(
        "fk", T.ScanTable(left), T.ScanTable(right),
        lhs_projector=T.Projector([("fk", "L.fk"), ("lv", "L.lv")]),
        rhs_projector=T.Projector([("name", "R.name"), ("w", "R.w")])))
    assert_tables_match(out, _golden_out("rowid_join"))


def test_golden_foreign_filter():
    filt, inp = _inputs("foreign_filter")
    out = T.execute(T.ForeignFilter("fk", "key", T.ScanTable(inp),
                                    T.ScanTable(filt)))
    assert_tables_match(out, _golden_out("foreign_filter"))


def test_golden_bench_compute():
    """bench_ops.py's "compute c0 * (sin + exp)" (operation_example.cc:
    44-50): torch's sin/exp against libm's in the last bits."""
    (t,) = _inputs("bench_compute")
    c = T.col
    out = T.execute(T.Compute(
        (c("col0") * (T.Sin(c("col2")) + T.Exp(c("col1")))).as_("expr"),
        T.ScanTable(t)))
    assert_tables_match(out, _golden_out("bench_compute"), float_rtol=1e-13)


def test_golden_proto_expression_interop():
    """The ExpressionDescription bytes the reference's
    BuildExpressionFromProto evaluated (refbuild/golden_dump.cc::
    CaseProtoExpr) through the port's deserializer: a + b * 2.0, pure
    float arithmetic, bit for bit."""
    (t,) = _inputs("proto_expr")
    expr = build_expression_from_proto_bytes(
        (GOLDEN / "proto_expr.pb").read_bytes())
    out = T.execute(T.Compute(expr.as_("r"), T.ScanTable(t)))
    assert_tables_match(out, _golden_out("proto_expr"))


def test_golden_expr_mix():
    """IsNull, IfNull, If, a nulling division, Length (UINT32), ToUpper and
    the date fields: every value exact."""
    (t,) = _inputs("expr_mix")
    a, b, s, d = T.col("a"), T.col("b"), T.col("s"), T.col("d")
    out = T.execute(T.Compute(
        [T.Plus(a, T.ConstInt32(7)).as_("plus7"),
         T.IsNull(a).as_("isnull"),
         T.IfNull(a, T.ConstInt32(-99)).as_("ifnull"),
         T.If(T.Greater(b, 0.0), a, T.ConstInt32(-1)).as_("ifgt"),
         T.DivideNulling(a, T.Modulus(a, T.ConstInt32(5))).as_("ndiv"),
         T.Length(s).as_("slen"),
         T.ToUpper(s).as_("supper"),
         T.Year(d).as_("year"),
         T.Month(d).as_("month"),
         T.Day(d).as_("day")],
        T.ScanTable(t)))
    assert out.schema.lookup("slen").type == T.UINT32
    assert_tables_match(out, _golden_out("expr_mix"))


@pytest.mark.parametrize("domains", [True, False],
                         ids=["domain", "no_domain"])
def test_golden_tostring(domains):
    """ToString of BOOL, DATE and INT32 in the reference's printer formats:
    through bind-time dictionaries under ``domain`` bounds, and without
    them through the per-row rendering after the run (DeferredRender)."""
    (t,) = _inputs("tostring")
    kw = ({"sd": {"domain": (0, 25000)}, "si": {"domain": (-500, 500)}}
          if domains else {"sd": {}, "si": {}})
    out = T.execute(T.Compute(
        [T.ToString(T.col("b")).as_("sb"),
         T.ToString(T.col("d"), **kw["sd"]).as_("sd"),
         T.ToString(T.col("i"), **kw["si"]).as_("si")],
        T.ScanTable(t)))
    assert_tables_match(out, _golden_out("tostring"))


def test_golden_stateful():
    """Changed, RunningSum, Smudge, SmudgeIf and RunningMinWithFlush as
    whole-column scans, row for row against the C++ engine's per-row
    state."""
    (t,) = _inputs("stateful")
    c = T.col
    out = T.execute(T.Compute(
        [T.Changed(c("seq")).as_("chg"),
         T.RunningSum(c("v")).as_("rsum"),
         T.Smudge(c("v")).as_("smu"),
         T.SmudgeIf(c("v"), c("flush")).as_("smuif"),
         T.RunningMinWithFlush(c("flush"), c("v")).as_("rmin")],
        T.ScanTable(t)))
    assert_tables_match(out, _golden_out("stateful"))


def test_golden_string_ops():
    """Substring (negative positions too), StringOffset, StringReplace and
    a Concat of two non-constant STRING columns (a cross dictionary)."""
    (t,) = _inputs("string_ops")
    c = T.col
    out = T.execute(T.Compute(
        [T.Substring(c("s"), 2, 3).as_("sub"),
         T.Substring(c("s"), -3, 2).as_("subn"),
         T.StringOffset(c("s"), "a").as_("off"),
         T.StringReplace(c("s"), "a", "oo").as_("rep"),
         T.Concat(c("s"), "-", c("s2")).as_("cat")],
        T.ScanTable(t)))
    assert_tables_match(out, _golden_out("string_ops"))


def test_golden_makedate():
    """MakeDate and MakeDatetime normalize months and days as mkgmtime_int64
    does; AddMonths over them."""
    (t,) = _inputs("makedate")
    c = T.col
    out = T.execute(T.Compute(
        [T.MakeDate(c("y"), c("m"), c("d")).as_("md"),
         T.MakeDatetime(c("y2"), c("m"), c("d"), c("h"), T.Const(90),
                        T.Const(-5)).as_("mdt"),
         T.AddMonths(T.MakeDate(c("y"), T.Const(1), c("d")),
                     c("m")).as_("addm")],
        T.ScanTable(t)))
    assert_tables_match(out, _golden_out("makedate"))


def test_golden_date_local():
    """The *Local fields and DateFormat/DateFormatLocal under
    America/New_York, the 2024 DST boundary instants included."""
    (t,) = _inputs("date_local")
    hi_us = 2_100_000_000 * 1_000_000
    c = T.col
    T.set_local_timezone("America/New_York")
    try:
        out = T.execute(T.Compute(
            [T.YearLocal(c("t")).as_("y"),
             T.MonthLocal(c("t")).as_("mo"),
             T.DayLocal(c("t")).as_("dy"),
             T.HourLocal(c("t")).as_("h"),
             T.MinuteLocal(c("t")).as_("mi"),
             T.WeekdayLocal(c("t")).as_("wd"),
             T.DateFormat(c("t"), "%Y/%m/%d %a",
                          domain=(0, hi_us)).as_("fmt"),
             T.DateFormatLocal(c("t"), "%Y/%m/%d %a",
                               domain=(0, hi_us)).as_("fmtl")],
            T.ScanTable(t)))
    finally:
        T.set_local_timezone(None)
    assert_tables_match(out, _golden_out("date_local"))
