"""The port against the real C++ engine's output (the goldens of
tests/test_golden.py): the inputs and outputs are read with the JAX
package's ``read_reference_file`` and moved into the port's tables with
``from_numpy``; the port's plan must give the C++ engine's rows, compared
by tests/test_golden.py's rule (ordered, every value and NULL exact).

The golden cases that need features the port does not have yet are listed
in ROADMAP.md (queue 1 item 10).  The group-by cases compare ordered by
their key, as tests/test_golden.py does (the row order of a hash group-by
is the engine's)."""
from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu.io.file_io import read_reference_file

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


def _schema(ns, cols):
    return ns.TupleSchema.of(*[(n, getattr(ns.DataType, t), nl)
                               for n, t, nl in cols])


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


def _to_port(jt, cols) -> "T.Table":
    """A JAX package table as a port table on the CPU."""
    n = int(jt.num_rows)
    arrays, dicts = {}, {}
    for name, _, nullable in cols:
        c = jt.columns[name]
        vals = np.array(c.values)[:n]  # a writable copy for torch
        arrays[name] = ((vals, np.array(c.valid)[:n]) if nullable
                        and c.valid is not None else vals)
        if name in jt.dicts:
            dicts[name] = T.Dictionary(tuple(jt.dicts[name].values))
    return T.Table.from_numpy(_schema(T, cols), arrays, None, dicts,
                              device="cpu")


def _inputs(case: str) -> list:
    return [_to_port(read_reference_file(_schema(J, cols), str(GOLDEN / f)),
                     cols)
            for f, cols in _manifest(case)["in"]]


def _golden_out(case: str):
    f, rows, cols = _manifest(case)["out"]
    t = read_reference_file(_schema(J, cols), str(GOLDEN / f))
    assert int(t.num_rows) == rows
    return t


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
    """The STRING inputs the goldens read come through from_numpy with
    their dictionaries, rows and NULLs intact."""
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
