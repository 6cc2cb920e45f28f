"""The port's tooling against the JAX package's, on the CPU: the capacity
sweep of ``testing/operation_testing.py``, the differential tests over the
port and its copy of ``reference/ref_engine.py``, the benchmark harness,
the entry twin of ``__graft_entry__.py`` and the headline twin of
``bench.py``.

The tests of tests/test_operation_testing.py, tests/test_differential.py,
tests/test_differential_sweep.py and tests/test_io_bench.py's harness
tests are mirrored here one for one, with the same seeds and
parametrisations, over the port's tables on the CPU."""
import json
import types

import numpy as np
import pytest
import torch

import supersonic_tpu_torch as T
from supersonic_tpu_torch import (DOUBLE, INT64, STRING, AggSpec,
                                  Aggregation, Filter, GroupAggregate,
                                  HashJoin, JoinType, KeyUniqueness,
                                  ScanTable, Sort, SortKey, TupleSchema, col,
                                  execute)
from supersonic_tpu_torch.bench import (benchmark_plan, describe_plan,
                                        format_stats, to_dot)
from supersonic_tpu_torch.reference import ref_engine as ref
from supersonic_tpu_torch.testing import OperationTest, check_operation

torch.set_num_threads(1)

CPU = {"device": "cpu"}


def table(schema, data, **kw):
    return T.Table.from_data(schema, data, device="cpu", **kw)


def check(*args, **kw):
    check_operation(*args, device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_operation_testing.py
# ---------------------------------------------------------------------------

def test_filter_sweep():
    check(
        lambda t: Filter(col("a") > 2, ScanTable(t)),
        [(TupleSchema.of(("a", INT64),), {"a": [1, 3, None, 5]})],
        [(3,), (5,)],
    )


def test_group_aggregate_sweep_fixture():
    t = OperationTest(device="cpu")
    t.add_input(TupleSchema.of(("k", INT64), ("v", INT64)),
                {"k": [1, 2, 1], "v": [10, 20, 30]})
    t.set_expected_result([(1, 40), (2, 20)])
    t.execute(lambda inp: GroupAggregate(
        ["k"], [AggSpec(Aggregation.SUM, "v", "s")], inp))


def test_sort_sweep_ignore_order_off():
    t = OperationTest(device="cpu")
    t.add_input(TupleSchema.of(("a", INT64),), {"a": [3, None, 1]})
    t.set_expected_result([(None,), (1,), (3,)])
    t.execute(lambda inp: Sort(["a"], inp))


def test_hash_join_sweep():
    check(
        lambda lt, rt: HashJoin(
            JoinType.LEFT_OUTER, ["fk"], ["pk"], ScanTable(lt),
            ScanTable(rt), KeyUniqueness.UNIQUE),
        [(TupleSchema.of(("fk", INT64),), {"fk": [1, 9, 2]}),
         (TupleSchema.of(("pk", INT64), ("w", INT64)),
          {"pk": [1, 2], "w": [10, 20]})],
        [(1, 1, 10), (9, None, None), (2, 2, 20)],
    )


def test_merge_union_sweep():
    check(
        lambda a, b: T.MergeUnionAll(["k"], [ScanTable(a), ScanTable(b)]),
        [(TupleSchema.of(("k", INT64),), {"k": [1, 5]}),
         (TupleSchema.of(("k", INT64),), {"k": [2, 3]})],
        [(1,), (2,), (3,), (5,)],
    )


def test_aggregate_clusters_sweep():
    check(
        lambda t: T.AggregateClusters(
            ["k"], [AggSpec(Aggregation.MIN, "v", "mn"),
                    AggSpec(Aggregation.MAX, "v", "mx")], ScanTable(t)),
        [(TupleSchema.of(("k", INT64), ("v", INT64)),
          {"k": [1, 1, 2, 1], "v": [3, 1, 9, 4]})],
        [(1, 1, 3), (2, 9, 9), (1, 4, 4)],
    )


def test_masked_join_under_sort_sweep():
    check(
        lambda lt, rt: Sort(
            ["w", "fk"],
            HashJoin(JoinType.INNER, ["fk"], ["pk"],
                     ScanTable(lt), ScanTable(rt), KeyUniqueness.UNIQUE)),
        [(TupleSchema.of(("fk", INT64),), {"fk": [2, 9, 1, None, 2]}),
         (TupleSchema.of(("pk", INT64), ("w", INT64, True)),
          {"pk": [1, 2, 3], "w": [10, 20, None]})],
        [(1, 1, 10), (2, 2, 20), (2, 2, 20)],
        ignore_row_order=False,
    )


def test_masked_left_outer_join_under_groupby_sweep():
    check(
        lambda lt, rt: GroupAggregate(
            ["w"], [AggSpec(Aggregation.COUNT, None, "n"),
                    AggSpec(Aggregation.SUM, "x", "sx")],
            HashJoin(JoinType.LEFT_OUTER, ["fk"], ["pk"],
                     ScanTable(lt), ScanTable(rt), KeyUniqueness.UNIQUE)),
        [(TupleSchema.of(("fk", INT64), ("x", INT64)),
          {"fk": [1, 9, 2, 1], "x": [5, 6, 7, 8]}),
         (TupleSchema.of(("pk", INT64), ("w", INT64)),
          {"pk": [1, 2], "w": [10, 20]})],
        [(10, 2, 13), (None, 1, 6), (20, 1, 7)],
    )


def test_filtered_masked_join_under_sort_sweep():
    check(
        lambda lt, rt: Sort(
            ["x"],
            Filter(col("x") > 5,
                   HashJoin(JoinType.INNER, ["fk"], ["pk"],
                            ScanTable(lt), ScanTable(rt),
                            KeyUniqueness.UNIQUE))),
        [(TupleSchema.of(("fk", INT64), ("x", INT64)),
          {"fk": [1, 2, 1, 2], "x": [4, 6, 8, 3]}),
         (TupleSchema.of(("pk", INT64), ("w", INT64)),
          {"pk": [2, 1], "w": [20, 10]})],
        [(2, 6, 2, 20), (1, 8, 1, 10)],
        ignore_row_order=False,
    )


def test_sweep_catches_a_padding_leak():
    """The sweep fails an operator that lets padding rows through: a
    plan reading every capacity row, not just the live ones."""
    class Leaky(T.Operation):
        def __init__(self, child):
            self.child = child

        def bind(self, ctx):
            cb = self.child.bind(ctx)

            def fn(rctx):
                t = cb.run(rctx)
                return T.Table(t.schema, t.columns, t.capacity, t.device,
                               t.dicts)
            return T.BoundOperation(cb.schema, cb.dicts, fn, cb.capacity)

    with pytest.raises(AssertionError, match="capacity="):
        check(lambda t: Leaky(ScanTable(t)),
              [(TupleSchema.of(("a", INT64, False),), {"a": [1, 2]})],
              [(1,), (2,)])


# ---------------------------------------------------------------------------
# tests/test_differential.py
# ---------------------------------------------------------------------------

def rand_table(rng, n, null_p=0.15):
    def maybe_null(vals):
        return [None if rng.random() < null_p else v for v in vals]

    schema = TupleSchema.of(("k", INT64), ("v", INT64), ("x", DOUBLE),
                            ("s", STRING))
    data = {
        "k": maybe_null(rng.integers(0, 6, n).tolist()),
        "v": maybe_null(rng.integers(-50, 50, n).tolist()),
        "x": maybe_null(np.round(rng.random(n) * 10, 3).tolist()),
        "s": maybe_null([f"w{int(i)}" for i in rng.integers(0, 5, n)]),
    }
    t = table(schema, data)
    return t, t.to_pylist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_differential(seed):
    rng = np.random.default_rng(seed)
    t, rows = rand_table(rng, 50)
    got = execute(Filter(col("v") > 0, ScanTable(t))).to_pylist()
    exp = ref.filter_rows(rows, lambda r: None if r[1] is None else r[1] > 0)
    assert got == exp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_differential(seed):
    rng = np.random.default_rng(seed + 10)
    t, rows = rand_table(rng, 60)
    got = execute(Sort([("k", True), SortKey("x", ascending=False)],
                       ScanTable(t))).to_pylist()
    assert got == ref.sort_rows(rows, [(0, True), (2, False)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_string_desc_differential(seed):
    rng = np.random.default_rng(seed + 20)
    t, rows = rand_table(rng, 40)
    got = execute(Sort([SortKey("s", ascending=False), ("v", True)],
                       ScanTable(t))).to_pylist()
    assert got == ref.sort_rows(rows, [(3, False), (1, True)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_aggregate_differential(seed):
    rng = np.random.default_rng(seed + 30)
    t, rows = rand_table(rng, 80)
    got = execute(GroupAggregate(
        ["k", "s"],
        [AggSpec(Aggregation.SUM, "v", "sv"),
         AggSpec(Aggregation.COUNT, "x", "cx"),
         AggSpec(Aggregation.MIN, "v", "mn"),
         AggSpec(Aggregation.MAX, "x", "mx"),
         AggSpec(Aggregation.FIRST, "v", "fv"),
         AggSpec(Aggregation.LAST, "x", "lx"),
         AggSpec(Aggregation.COUNT, None, "n")],
        ScanTable(t))).to_pylist()
    exp = ref.group_aggregate(
        rows, [0, 3],
        [("sum", 1), ("count", 2), ("min", 1), ("max", 2),
         ("first", 1), ("last", 2), ("count_star", None)])
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g[:3] == e[:3] and g[4] == e[4] and g[6] == e[6] \
            and g[8] == e[8]
        for gi, ei in ((g[3], e[3]), (g[5], e[5]), (g[7], e[7])):
            if ei is None:
                assert gi is None
            else:
                assert gi == pytest.approx(ei)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.LEFT_OUTER])
def test_join_differential(seed, join_type):
    rng = np.random.default_rng(seed + 40)
    lt, lrows = rand_table(rng, 40)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": rng.choice(20, size=8, replace=False).tolist(),
             "w": rng.integers(0, 100, 8).tolist()}
    rt = table(rs, rdata)
    got = execute(HashJoin(join_type, ["k"], ["pk"], ScanTable(lt),
                           ScanTable(rt), KeyUniqueness.UNIQUE)).to_pylist()
    assert got == ref.hash_join(lrows, rt.to_pylist(), 0, 0,
                                join_type == JoinType.LEFT_OUTER, rhs_width=2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.LEFT_OUTER])
@pytest.mark.parametrize("allow_dense", [True, False])
def test_join_not_unique_differential(seed, join_type, allow_dense):
    rng = np.random.default_rng(seed + 60)
    lt, lrows = rand_table(rng, 35)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": rng.integers(0, 8, 12).tolist(),
             "w": rng.integers(0, 100, 12).tolist()}
    rt = table(rs, rdata)
    got = execute(HashJoin(join_type, ["k"], ["pk"], ScanTable(lt),
                           ScanTable(rt), KeyUniqueness.NOT_UNIQUE,
                           out_capacity=1024,
                           allow_dense_lookup=allow_dense)).to_pylist()
    assert got == ref.hash_join(lrows, rt.to_pylist(), 0, 0,
                                join_type == JoinType.LEFT_OUTER, rhs_width=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extended_sort_limit_differential(seed):
    rng = np.random.default_rng(seed + 70)
    t, rows = rand_table(rng, 70)
    got = execute(T.ExtendedSort([("x", False), ("v", True)], ScanTable(t),
                                 limit=9)).to_pylist()
    assert got == ref.sort_rows(rows, [(2, False), (1, True)])[:9]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_multikey_group_differential(seed):
    # non-nullable small-domain keys take the dense path
    rng = np.random.default_rng(seed + 80)
    n = 90
    schema = TupleSchema.of(("a", INT64, False), ("s", STRING, False),
                            ("v", INT64), ("x", DOUBLE))
    data = {
        "a": rng.integers(0, 5, n).tolist(),
        "s": [f"g{int(i)}" for i in rng.integers(0, 4, n)],
        "v": [None if rng.random() < 0.2 else int(v)
              for v in rng.integers(-30, 30, n)],
        "x": np.round(rng.random(n) * 5, 3).tolist(),
    }
    t = table(schema, data)
    rows = t.to_pylist()
    got = execute(GroupAggregate(
        ["a", "s"],
        [AggSpec(Aggregation.SUM, "v", "sv"),
         AggSpec(Aggregation.MIN, "x", "mn"),
         AggSpec(Aggregation.COUNT, None, "n")],
        ScanTable(t))).to_pylist()
    exp = ref.group_aggregate(rows, [0, 1],
                              [("sum", 2), ("min", 3), ("count_star", None)])
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g[0] == e[0] and g[1] == e[1] and g[2] == e[2] \
            and g[4] == e[4]
        if e[3] is None:
            assert g[3] is None
        else:
            assert g[3] == pytest.approx(e[3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int64_sum_differential_extreme_magnitudes(seed):
    rng = np.random.default_rng(seed + 400)
    n = 200
    ks = rng.integers(0, 5, n).tolist()
    vs = [None if rng.random() < 0.1 else
          int(rng.integers(-(2**62), 2**62))
          for _ in range(n)]
    t = table(TupleSchema.of(("k", INT64, False), ("v", INT64)),
              {"k": ks, "v": vs})
    got = execute(GroupAggregate(
        ["k"], [AggSpec(Aggregation.SUM, "v", "sv")],
        ScanTable(t))).to_pylist()

    def wrap(x):
        x %= 1 << 64
        return x - (1 << 64) if x >= 1 << 63 else x

    exp, order = {}, []
    for k, v in zip(ks, vs):
        if k not in exp:
            exp[k] = None
            order.append(k)
        if v is not None:
            exp[k] = v if exp[k] is None else exp[k] + v
    assert got == [(k, None if exp[k] is None else wrap(exp[k]))
                   for k in order]


# ---------------------------------------------------------------------------
# tests/test_differential_sweep.py
# ---------------------------------------------------------------------------

SWEEP_SCHEMA = TupleSchema.of(("k", INT64), ("v", INT64), ("x", DOUBLE),
                              ("s", STRING))


def rand_data(rng, n, null_p=0.15, key_dom=25):
    def maybe_null(vals):
        return [None if rng.random() < null_p else v for v in vals]

    return {
        "k": maybe_null(rng.integers(0, key_dom, n).tolist()),
        "v": maybe_null(rng.integers(-50, 50, n).tolist()),
        "x": maybe_null(np.round(rng.random(n) * 10, 3).tolist()),
        "s": maybe_null([f"w{int(i)}" for i in rng.integers(0, 12, n)]),
    }


def rows_of(data, n):
    return [tuple(data[c][i] for c in ("k", "v", "x", "s"))
            for i in range(n)]


@pytest.mark.parametrize("seed,n", [(0, 1000), (1, 2500), (2, 777)])
def test_filter_differential_swept(seed, n):
    rng = np.random.default_rng(seed + 100)
    data = rand_data(rng, n)
    exp = ref.filter_rows(rows_of(data, n),
                          lambda r: None if r[1] is None else r[1] > 0)
    check(lambda t: Filter(col("v") > 0, ScanTable(t)),
          [(SWEEP_SCHEMA, data)], exp)


@pytest.mark.parametrize("seed,n", [(0, 1200), (1, 3000)])
def test_sort_differential_swept(seed, n):
    rng = np.random.default_rng(seed + 110)
    data = rand_data(rng, n)
    exp = ref.sort_rows(rows_of(data, n), [(0, True), (2, False)])
    check(lambda t: Sort([("k", True), SortKey("x", ascending=False)],
                         ScanTable(t)),
          [(SWEEP_SCHEMA, data)], exp)


@pytest.mark.parametrize("seed,n", [(0, 1500), (1, 4000)])
def test_group_aggregate_differential_swept(seed, n):
    rng = np.random.default_rng(seed + 120)
    data = rand_data(rng, n, key_dom=60)
    exp = ref.group_aggregate(
        rows_of(data, n), [0],
        [("sum", 1), ("min", 1), ("max", 1), ("count", 2),
         ("count_star", None)])
    check(lambda t: GroupAggregate(
        ["k"],
        [AggSpec(Aggregation.SUM, "v", "sv"),
         AggSpec(Aggregation.MIN, "v", "mn"),
         AggSpec(Aggregation.MAX, "v", "mx"),
         AggSpec(Aggregation.COUNT, "x", "cx"),
         AggSpec(Aggregation.COUNT, None, "c")],
        ScanTable(t)), [(SWEEP_SCHEMA, data)], exp)


@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.LEFT_OUTER])
@pytest.mark.parametrize("allow_dense", [True, False])
def test_join_differential_swept(join_type, allow_dense):
    rng = np.random.default_rng(130)
    n = 1200
    data = rand_data(rng, n, key_dom=40)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": rng.choice(60, size=25, replace=False).tolist(),
             "w": rng.integers(0, 100, 25).tolist()}
    rrows = [(rdata["pk"][i], rdata["w"][i]) for i in range(25)]
    exp = ref.hash_join(rows_of(data, n), rrows, 0, 0,
                        join_type == JoinType.LEFT_OUTER, rhs_width=2)
    check(lambda lt, rt: HashJoin(join_type, ["k"], ["pk"], ScanTable(lt),
                                  ScanTable(rt), KeyUniqueness.UNIQUE,
                                  allow_dense_lookup=allow_dense),
          [(SWEEP_SCHEMA, data), (rs, rdata)], exp)


@pytest.mark.parametrize("allow_dense", [True, False])
def test_not_unique_expansion_near_capacity_differential(allow_dense):
    """High-duplication NOT_UNIQUE expansion with out_capacity at 100%
    and ~104% of the exact output size."""
    rng = np.random.default_rng(140)
    n, dup_keys, dups = 800, 10, 6
    data = rand_data(rng, n, null_p=0.05, key_dom=dup_keys)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": np.repeat(np.arange(dup_keys), dups).tolist(),
             "w": rng.integers(0, 100, dup_keys * dups).tolist()}
    rrows = [(rdata["pk"][i], rdata["w"][i])
             for i in range(dup_keys * dups)]
    exp = ref.hash_join(rows_of(data, n), rrows, 0, 0, False, rhs_width=2)
    for cap in (len(exp), int(len(exp) * 1.04)):
        got = execute(HashJoin(
            JoinType.INNER, ["k"], ["pk"],
            ScanTable(table(SWEEP_SCHEMA, data)), ScanTable(table(rs, rdata)),
            KeyUniqueness.NOT_UNIQUE, out_capacity=cap,
            allow_dense_lookup=allow_dense)).to_pylist()
        assert got == exp, f"cap={cap}"


def test_join_out_capacity_overflow_raises_differentially():
    rng = np.random.default_rng(150)
    n = 500
    data = rand_data(rng, n, null_p=0.0, key_dom=5)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": np.repeat(np.arange(5), 4).tolist(),
             "w": list(range(20))}
    exact = len(ref.hash_join(
        rows_of(data, n),
        [(rdata["pk"][i], rdata["w"][i]) for i in range(20)],
        0, 0, False, rhs_width=2))
    with pytest.raises(T.EvaluationError):
        execute(HashJoin(
            JoinType.INNER, ["k"], ["pk"],
            ScanTable(table(SWEEP_SCHEMA, data)), ScanTable(table(rs, rdata)),
            KeyUniqueness.NOT_UNIQUE, out_capacity=exact - 10))


# ---------------------------------------------------------------------------
# tests/test_io_bench.py's harness tests, and describe_plan against JAX
# ---------------------------------------------------------------------------

def make_table(ns=T):
    schema = ns.TupleSchema.of(("a", ns.INT64), ("b", ns.DOUBLE),
                               ("s", ns.STRING))
    return ns.Table.from_data(schema, {
        "a": [1, None, 3], "b": [1.5, 2.5, None], "s": ["x", None, "yy"]},
        **({} if ns is not T else CPU))


def test_benchmark_harness():
    t = make_table()
    plan = GroupAggregate(["s"], [AggSpec(Aggregation.SUM, "a", "sa")],
                          Filter(col("a") > 0, ScanTable(t)))
    stats = benchmark_plan(plan, iters=1)
    assert stats.name == "GroupAggregate"
    assert stats.children[0].name == "Filter"
    assert stats.children[0].children[0].name == "ScanTable"
    assert stats.rows_processed == 2  # groups: "x", "yy"
    assert stats.children[0].rows_processed == 2
    assert stats.children[0].children[0].rows_processed == 3
    table_txt = format_stats(stats)
    assert "GroupAggregate" in table_txt and "rows/µs" in table_txt
    assert "whole plan" in table_txt and "sum of per-node self" in table_txt
    dot = to_dot(stats)
    assert dot.startswith("digraph") and "Filter" in dot


def test_describe_plan():
    t = table(TupleSchema.of(("g", T.INT32), ("v", DOUBLE)),
              {"g": [1, 2, 1], "v": [1.0, 2.0, None]})
    plan = Sort([SortKey("sv", ascending=False)],
                GroupAggregate(["g"], [AggSpec(Aggregation.SUM, "v", "sv")],
                               Filter(col("v") > 0.5, ScanTable(t))))
    txt = describe_plan(plan)
    assert "Sort" in txt and "GroupAggregate" in txt and "Filter" in txt
    assert "sv DESC" in txt and "sv: DOUBLE?" in txt
    lines = txt.splitlines()
    assert lines[3].startswith("      ScanTable")


def _described_plans(ns, kw):
    """Plans over every node kind describe_plan details."""
    t = ns.Table.from_data(
        ns.TupleSchema.of(("g", ns.INT32), ("v", ns.DOUBLE),
                          ("s", ns.STRING)),
        {"g": [1, 2, 1], "v": [1.0, 2.0, None], "s": ["a", None, "b"]},
        **kw)
    d = ns.Table.from_data(
        ns.TupleSchema.of(("pk", ns.INT32, False), ("w", ns.INT64)),
        {"pk": [1, 2], "w": [10, None]}, **kw)
    agg = ns.GroupAggregate(
        ["g", "s"], [ns.AggSpec(ns.Aggregation.SUM, "v", "sv"),
                     ns.AggSpec(ns.Aggregation.COUNT, None, "c")],
        ns.Filter(ns.col("v") > 0.5, ns.ScanTable(t)))
    return [
        ns.Sort([ns.SortKey("sv", ascending=False), ns.SortKey("g")], agg),
        ns.Limit(1, 2, ns.Compute(
            [ns.Alias("x", ns.col("g") + ns.Const(1, ns.INT32))],
            ns.HashJoin(ns.JoinType.LEFT_OUTER, ["g"], ["pk"],
                        ns.ScanTable(t), ns.ScanTable(d),
                        ns.KeyUniqueness.UNIQUE))),
        ns.ExtendedSort([("s", False)], ns.ScanTable(t), limit=2),
    ]


def test_describe_plan_equals_jax_text():
    import supersonic_tpu as J
    from supersonic_tpu.bench import describe_plan as j_describe

    for got, want in zip(_described_plans(T, CPU), _described_plans(J, {})):
        for schemas in (True, False):
            assert describe_plan(got, schemas) == j_describe(want, schemas)


def test_benchmark_join_phase_split():
    """HashJoin nodes report index_set_up_time vs matching_time
    (reference: cursor_statistics.h:153-167, benchmark.proto:40-47)."""
    rng = np.random.default_rng(5)
    n, m = 5000, 500
    fact = table(TupleSchema.of(("fk", INT64, False)),
                 {"fk": rng.integers(0, m, n)})
    dim = table(TupleSchema.of(("pk", INT64, False), ("w", INT64, False)),
                {"pk": np.arange(m), "w": np.arange(m) * 3})
    join = HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                    ScanTable(dim), KeyUniqueness.UNIQUE)
    stats = benchmark_plan(join, iters=1)
    assert stats.rows_processed == n
    assert stats.index_set_up_time_us is not None
    assert stats.matching_time_us is not None
    assert stats.index_set_up_time_us + stats.matching_time_us \
        <= stats.processing_time_us + 1e-6
    assert "index_set_up" in format_stats(stats)
    # non-join nodes carry no split
    assert stats.children[0].index_set_up_time_us is None


def test_join_phase_split_failure_is_visible(caplog, monkeypatch):
    """A build-only re-timing that fails logs a warning and reports no
    split; it is never skipped silently."""
    from supersonic_tpu_torch.bench import harness

    def boom(op):
        raise RuntimeError("no probe")

    monkeypatch.setattr(harness, "_empty_probe_like", boom)
    fact = table(TupleSchema.of(("fk", INT64, False)), {"fk": [1, 2]})
    dim = table(TupleSchema.of(("pk", INT64, False)), {"pk": [1, 2]})
    with caplog.at_level("WARNING"):
        stats = benchmark_plan(HashJoin(
            JoinType.INNER, ["fk"], ["pk"], ScanTable(fact), ScanTable(dim),
            KeyUniqueness.UNIQUE), iters=1)
    assert stats.index_set_up_time_us is None
    assert "join phase split skipped" in caplog.text


# ---------------------------------------------------------------------------
# the entry and headline twins, and the names
# ---------------------------------------------------------------------------

def test_entry_matches_graft_entry():
    """``entry(device="cpu")``'s sv values and row count against
    ``__graft_entry__.entry()`` run by the JAX package on its CPU
    backend."""
    import jax

    import __graft_entry__ as G
    from supersonic_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    sv, n, flags = fn(*args)
    jfn, jargs = G.entry()
    jsv, jn, jflags = jax.jit(jfn)(*jargs)
    n = int(n)
    assert n == int(jn) == 64
    assert not flags.any() and not np.asarray(jflags).any()
    np.testing.assert_allclose(sv[:n].numpy(), np.asarray(jsv)[:n],
                               rtol=1e-5)
    assert sv.dtype == torch.float32


def test_headline_twin_prints_one_checked_json_line(capsys):
    from supersonic_tpu_torch.bench import headline

    assert headline.main(["--fact-rows", "20000", "--dim-rows", "3000",
                          "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "pipeline_rows_per_s" and rec["unit"] == "rows/s"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    fact, dim = headline.build_data(20000, 3000)
    assert (fact["fk"] < 3000).all() and (dim["g"] < headline.GROUPS).all()
    ft, dt = headline.build_tables(T, fact, dim, "cpu")
    out = execute(headline.build_plan(T, ft, dt))
    assert headline.check_result(out, fact, dim) == 64
    bad = T.Table.from_data(out.schema, {
        "g": [r[0] for r in out.to_pylist()],
        "sv": [r[1] * 1.01 for r in out.to_pylist()],
        "c": [r[2] for r in out.to_pylist()]}, device="cpu")
    with pytest.raises(AssertionError):
        headline.check_result(bad, fact, dim)


def _public(module) -> set:
    """A module's public names: a package's exports (submodules left
    out), or the functions, classes and constants a module defines (the
    names it imports, such as ``jax`` or ``Optional``, left out)."""
    names = set()
    for n in dir(module):
        obj = getattr(module, n)
        if n.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        if (hasattr(module, "__path__")
                or getattr(obj, "__module__", module.__name__)
                == module.__name__):
            names.add(n)
    return names


@pytest.mark.parametrize("name", [
    "parallel", "parallel.dist", "parallel.hashing", "parallel.multihost",
    "bench", "bench.harness", "testing", "testing.operation_testing",
    "reference.ref_engine"])
def test_tooling_names_cover_jax(name):
    """Every public name of the JAX package's module exists in the port's
    module of the same name."""
    import importlib

    j = importlib.import_module(f"supersonic_tpu.{name}")
    t = importlib.import_module(f"supersonic_tpu_torch.{name}")
    assert _public(j) <= set(dir(t)), sorted(_public(j) - set(dir(t)))
    assert _public(j), name
