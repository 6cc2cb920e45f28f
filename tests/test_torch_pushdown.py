"""The port's one binding of a group-by over an INNER or LEFT_OUTER join,
held to the JAX package's under both of its bindings, on the CPU,
mirroring tests/test_agg_pushdown.py.  The JAX package rewrites such a
plan by default (its aggregate pushdown: pregroup the probe side by its
join key, join the partials, aggregate again, Sort by first position when
ordered); the port binds it directly.  Each case asserts that the JAX
rewrite fires, or declines, where it does in tests/test_agg_pushdown.py,
and that the port's rows equal the rewrite's and the JAX direct binding's,
with the same output schema (COUNT a non-nullable UINT64).  That includes
the ordered NOT_UNIQUE rewrite, whose join takes the merge probe, and a
STRING join key ranged by its dictionary."""
import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu.ops.aggregate as JA
import supersonic_tpu_torch as T

from torch_parity import (DIM_SCHEMA, FACT_SCHEMA, headline_data,
                          headline_plan, jax_table, tables, torch_table)

torch.set_num_threads(1)


@pytest.fixture
def counted(monkeypatch):
    """{"J": the JAX package's fired rewrites}."""
    calls = {"J": 0}
    orig = JA.GroupAggregate._try_aggregate_pushdown

    def wrap(self, ctx, uo):
        r = orig(self, ctx, uo)
        calls["J"] += r is not None
        return r

    monkeypatch.setattr(JA.GroupAggregate, "_try_aggregate_pushdown", wrap)
    return calls


def _jax(plan, pushdown: bool):
    """A JAX plan with its aggregate's binding set."""
    agg = plan.child if isinstance(plan, J.Sort) else plan
    agg._pushdown_disabled = not pushdown
    return plan


def _run(plan_fn, jargs, targs):
    """(the port, JAX through the pushdown, JAX direct)."""
    return (T.execute(plan_fn(T, *targs)),
            J.execute(_jax(plan_fn(J, *jargs), True)),
            J.execute(_jax(plan_fn(J, *jargs), False)))


def _rows_close(got, want, rtol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if isinstance(x, float):
                assert y is not None and abs(x - y) <= rtol * max(
                    1.0, abs(y)), (a, b)
            else:
                assert x == y, (a, b)


def _schema(t):
    return [(a.name, a.type.value, a.nullable) for a in t.schema]


def _check(got, pushed, direct):
    """The port's rows equal the JAX pushdown's within rtol 1e-4 and the
    JAX direct binding's within 1e-5; the three schemas are equal."""
    assert _schema(got) == _schema(pushed) == _schema(direct)
    _rows_close(got.to_pylist(), pushed.to_pylist(), 1e-4)
    _rows_close(got.to_pylist(), direct.to_pylist(), 1e-5)


FACT_COLS = (("fk", "INT32", False), ("v", "FLOAT", False),
             ("iv", "INT64", True))


def _data(n=20000, m=3000, G=17, seed=5):
    rng = np.random.default_rng(seed)
    fact = {"fk": rng.integers(0, m, n).astype(np.int32),
            "v": rng.random(n, dtype=np.float32),
            "iv": (rng.integers(-50, 50, n), rng.random(n) < 0.9)}
    dim = {"pk": np.arange(m, dtype=np.int32),
           "g": rng.integers(0, G, m).astype(np.int32)}
    jf, tf = tables(J, T, FACT_COLS, fact)
    jd, td = tables(J, T, DIM_SCHEMA, dim)
    return (jf, jd), (tf, td)


def _plan(ns, fact, dim, filtered=True):
    child = ns.ScanTable(fact)
    if filtered:
        child = ns.Filter(ns.col("v") > ns.Const(0.5, ns.DataType.FLOAT),
                          child)
    A = ns.Aggregation
    return ns.GroupAggregate(
        ["g"],
        [ns.AggSpec(A.SUM, "iv", "si"), ns.AggSpec(A.COUNT, None, "c"),
         ns.AggSpec(A.MIN, "v", "mn"), ns.AggSpec(A.MAX, "iv", "mx")],
        ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], child,
                    ns.ScanTable(dim), ns.KeyUniqueness.UNIQUE,
                    lhs_projector=ns.Projector.named("v", "iv"),
                    rhs_projector=ns.Projector.named("g")),
        ns.GroupAggregateOptions(estimated_result_row_count=64))


def test_pushdown_ordered_exact(counted):
    """Insertion order (MIN of first positions, then a Sort) row for row,
    with the direct binding's schema: COUNT a non-nullable UINT64."""
    jargs, targs = _data()
    got, pushed, direct = _run(_plan, jargs, targs)
    assert counted == {"J": 1}, "pushdown did not fire"
    _check(got, pushed, direct)
    assert got.schema.lookup("c").type == T.UINT64
    assert not got.schema.lookup("c").nullable


def test_pushdown_under_sort_unordered(counted):
    jargs, targs = _data(seed=11)

    def p(ns, f, d):
        return ns.Sort([ns.SortKey("si", ascending=False)], _plan(ns, f, d))

    got, pushed, direct = _run(p, jargs, targs)
    assert counted == {"J": 1}
    _check(got, pushed, direct)


def test_pushdown_count_as_sum_and_empty_groups(counted):
    """INNER groups exist only for matched keys; COUNT counts the non-NULL
    inputs, and in the JAX rewrite becomes a SUM of INT32 partial counts
    into UINT64: the port's rows equal both JAX bindings' exactly."""
    rng = np.random.default_rng(3)
    n, m = 9000, 500
    cols = (("fk", "INT32", False), ("x", "INT32", True))
    jf, tf = tables(J, T, cols, {
        "fk": rng.integers(0, 2 * m, n).astype(np.int32),  # half unmatched
        "x": (rng.integers(0, 9, n).astype(np.int32), rng.random(n) < 0.5)})
    jd, td = tables(J, T, DIM_SCHEMA, {
        "pk": np.arange(m, dtype=np.int32),
        "g": rng.integers(0, 7, m).astype(np.int32)})

    def p(ns, f, d):
        A = ns.Aggregation
        return ns.GroupAggregate(
            ["g"], [ns.AggSpec(A.COUNT, "x", "cx"),
                    ns.AggSpec(A.SUM, "x", "sx")],
            ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(f),
                        ns.ScanTable(d), ns.KeyUniqueness.UNIQUE,
                        lhs_projector=ns.Projector.named("x"),
                        rhs_projector=ns.Projector.named("g")),
            ns.GroupAggregateOptions(estimated_result_row_count=16))

    got, pushed, direct = _run(p, (jf, jd), (tf, td))
    assert counted == {"J": 1}
    _check(got, pushed, direct)
    assert got.to_pylist() == pushed.to_pylist() == direct.to_pylist()


def test_pushdown_string_group_key(counted):
    rng = np.random.default_rng(9)
    n, m = 20000, 2000
    words = ("aa", "bb", "cc", "dd", "ee")
    jf, tf = tables(J, T, (("fk", "INT32", False), ("v", "FLOAT", False)), {
        "fk": rng.integers(0, m, n).astype(np.int32),
        "v": rng.random(n, dtype=np.float32)})
    jd, td = tables(J, T, (("pk", "INT32", False), ("s", "STRING", False)), {
        "pk": np.arange(m, dtype=np.int32),
        "s": (np.arange(m) % 5).astype(np.int32)}, {"s": words})

    def p(ns, f, d):
        return ns.GroupAggregate(
            ["s"], [ns.AggSpec(ns.Aggregation.SUM, "v", "sv")],
            ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(f),
                        ns.ScanTable(d), ns.KeyUniqueness.UNIQUE,
                        lhs_projector=ns.Projector.named("v"),
                        rhs_projector=ns.Projector.named("s")),
            ns.GroupAggregateOptions(estimated_result_row_count=16))

    got, pushed, direct = _run(p, (jf, jd), (tf, td))
    assert counted == {"J": 1}
    _check(got, pushed, direct)
    assert sorted(r[0] for r in got.to_pylist()) == list(words)


def test_pushdown_declines_ineligible(counted):
    """The JAX package declines the rewrite for: a probe side too small to
    shrink, group keys from the probe side, aggregate inputs from the build
    side, FIRST (not decomposable); the port's rows are its direct
    binding's."""
    (jf, jd), (tf, td) = _data(n=4000, m=3000)  # range * 4 > capacity
    got = T.execute(_plan(T, tf, td))
    want = J.execute(_jax(_plan(J, jf, jd), True))
    assert _schema(got) == _schema(want)
    _rows_close(got.to_pylist(), want.to_pylist(), 1e-5)
    (jf, jd), (tf, td) = _data()

    def probe_key(ns, f, d):
        return ns.GroupAggregate(
            ["fk2"], [ns.AggSpec(ns.Aggregation.SUM, "v", "sv")],
            ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(f),
                        ns.ScanTable(d), ns.KeyUniqueness.UNIQUE,
                        lhs_projector=ns.Projector([("fk", "fk2"),
                                                    ("v", None)]),
                        rhs_projector=ns.Projector.named("g")),
            ns.GroupAggregateOptions(estimated_result_row_count=4096))

    def build_input(ns, f, d):
        return ns.GroupAggregate(
            ["g"], [ns.AggSpec(ns.Aggregation.MAX, "pk2", "mp")],
            ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(f),
                        ns.ScanTable(d), ns.KeyUniqueness.UNIQUE,
                        lhs_projector=ns.Projector.named("v"),
                        rhs_projector=ns.Projector([("pk", "pk2"),
                                                    ("g", None)])),
            ns.GroupAggregateOptions(estimated_result_row_count=64))

    def first(ns, f, d):
        return ns.GroupAggregate(
            ["g"], [ns.AggSpec(ns.Aggregation.FIRST, "v", "fv")],
            ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(f),
                        ns.ScanTable(d), ns.KeyUniqueness.UNIQUE,
                        lhs_projector=ns.Projector.named("v"),
                        rhs_projector=ns.Projector.named("g")),
            ns.GroupAggregateOptions(estimated_result_row_count=64))

    got = T.execute(probe_key(T, tf, td)).to_pylist()
    want = J.execute(_jax(probe_key(J, jf, jd), True)).to_pylist()
    assert [r[0] for r in got] == [r[0] for r in want]
    fk, v = tf.columns["fk"].values.numpy(), tf.columns["v"].values.numpy()
    sums = np.bincount(fk, weights=v.astype(np.float64))
    np.testing.assert_allclose([r[1] for r in got],
                               [sums[r[0]] for r in got], rtol=1e-6)
    for make in (build_input, first):  # binds only: no row is compared
        make(T, tf, td).bind(T.BindContext())
        _jax(make(J, jf, jd), True).bind(J.BindContext())
    assert counted == {"J": 0}


def _not_unique_data(n=20000, m=2000, seed=5):
    rng = np.random.default_rng(seed)
    pk = np.repeat(np.arange(m // 4, dtype=np.int32), 4)
    rng.shuffle(pk)
    dim = {"pk": pk, "g": rng.integers(0, 13, m).astype(np.int32)}
    fact = {"fk": rng.integers(0, m // 4 + 30, n).astype(np.int32),
            "v": rng.random(n, dtype=np.float32),
            "iv": (rng.integers(-50, 50, n), rng.random(n) < 0.9)}
    jf, tf = tables(J, T, FACT_COLS, fact)
    jd, td = tables(J, T, DIM_SCHEMA, dim)
    return (jf, jd), (tf, td)


def _not_unique_agg(ns, f, d, n=20000):
    A = ns.Aggregation
    return ns.GroupAggregate(
        ["g"], [ns.AggSpec(A.SUM, "iv", "si"), ns.AggSpec(A.COUNT, None, "c"),
                ns.AggSpec(A.MIN, "v", "mn")],
        ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(f),
                    ns.ScanTable(d), ns.KeyUniqueness.NOT_UNIQUE,
                    lhs_projector=ns.Projector.named("v", "iv"),
                    rhs_projector=ns.Projector.named("g"),
                    out_capacity=5 * n),
        ns.GroupAggregateOptions(estimated_result_row_count=32))


def test_pushdown_not_unique_under_sort(counted):
    """A NOT_UNIQUE INNER join decomposes under a Sort (each (partial,
    build row) pair adds its partial once per duplicate)."""
    jargs, targs = _not_unique_data()

    def p(ns, f, d):
        return ns.Sort([ns.SortKey("si", ascending=False)],
                       _not_unique_agg(ns, f, d))

    got, pushed, direct = _run(p, jargs, targs)
    assert counted == {"J": 1}
    _check(got, pushed, direct)


def test_ordered_not_unique_pushdown_declines(counted):
    """The ordered NOT_UNIQUE rewrite ranks groups by the least (first
    probe position, build row) pair, whose build row is a computed column
    without statistics, so its join takes the merge probe.  It fires in
    the JAX package; the port's rows equal its rows and the JAX direct
    binding's."""
    jargs, targs = _not_unique_data()
    got, pushed, direct = _run(_not_unique_agg, jargs, targs)
    assert counted == {"J": 1}
    _check(got, pushed, direct)


def test_string_join_key_pushdown_declines(counted):
    """A STRING join key is ranged by its dictionary: the JAX rewrite
    fires, and the port's rows equal its rows and the JAX direct
    binding's."""
    rng = np.random.default_rng(12)
    n, m = 400, 20
    words = tuple(f"k{i:02d}" for i in range(m))
    jf, tf = tables(J, T, (("fk", "STRING", False), ("v", "FLOAT", False)), {
        "fk": rng.integers(0, m, n).astype(np.int32),
        "v": rng.random(n, dtype=np.float32)}, {"fk": words})
    jd, td = tables(J, T, (("pk", "STRING", False), ("g", "INT32", False)), {
        "pk": np.arange(m, dtype=np.int32),
        "g": rng.integers(0, 3, m).astype(np.int32)}, {"pk": words})

    def p(ns, f, d):
        return ns.GroupAggregate(
            ["g"], [ns.AggSpec(ns.Aggregation.SUM, "v", "sv")],
            ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(f),
                        ns.ScanTable(d), ns.KeyUniqueness.UNIQUE,
                        lhs_projector=ns.Projector.named("v"),
                        rhs_projector=ns.Projector.named("g")))

    got, pushed, direct = _run(p, (jf, jd), (tf, td))
    assert counted == {"J": 1}
    _check(got, pushed, direct)


@pytest.mark.parametrize("ordered", [True, False])
def test_pushdown_string_key_not_unique_separate_dictionaries(counted,
                                                              ordered):
    """The ordered and the sorted NOT_UNIQUE rewrite over a STRING join key
    whose build side has a dictionary of its own, holding words the probe
    lacks: the rewritten join remaps the build side and ranks groups by
    (probe, build row) pairs through the merge probe; the port's rows are
    the JAX package's under both bindings."""
    rng = np.random.default_rng(23)
    n, m = 600, 90
    lw = tuple(f"k{i:02d}" for i in range(0, 40, 2))
    rw = tuple(f"k{i:02d}" for i in range(0, 40, 3))
    jf, tf = tables(J, T, (("fk", "STRING", False), ("v", "FLOAT", False)), {
        "fk": rng.integers(0, len(lw), n).astype(np.int32),
        "v": rng.random(n, dtype=np.float32)}, {"fk": lw})
    jd, td = tables(J, T, (("pk", "STRING", False), ("g", "INT32", True)), {
        "pk": rng.integers(0, len(rw), m).astype(np.int32),
        "g": (rng.integers(0, 5, m).astype(np.int32),
              rng.random(m) < 0.9)}, {"pk": rw})

    def agg(ns, f, d):
        A = ns.Aggregation
        return ns.GroupAggregate(
            ["g"], [ns.AggSpec(A.SUM, "v", "sv"),
                    ns.AggSpec(A.COUNT, None, "c")],
            ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(f),
                        ns.ScanTable(d), ns.KeyUniqueness.NOT_UNIQUE,
                        lhs_projector=ns.Projector.named("v"),
                        rhs_projector=ns.Projector.named("g"),
                        out_capacity=8 * n),
            ns.GroupAggregateOptions(estimated_result_row_count=16))

    def p(ns, f, d):
        return agg(ns, f, d) if ordered else ns.Sort(
            [ns.SortKey("sv", False)], agg(ns, f, d))

    got, pushed, direct = _run(p, (jf, jd), (tf, td))
    assert counted == {"J": 1}
    _check(got, pushed, direct)


@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
@pytest.mark.parametrize("ordered", [True, False])
def test_pushdown_left_outer(counted, uniq, ordered):
    """LEFT_OUTER decomposes too: an unmatched probe row's partial emits
    one NULL-rhs row, so the NULL-key group gets the same partials.  The
    ordered NOT_UNIQUE case ranks by (probe, build row) pairs through the
    merge probe."""
    rng = np.random.default_rng(5)
    n, m = 20000, 2000
    dup = 1 if uniq == "UNIQUE" else 4
    if dup == 1:
        pk = np.arange(m, dtype=np.int32)
    else:
        pk = np.repeat(np.arange(m // dup, dtype=np.int32), dup)
        rng.shuffle(pk)
    jd, td = tables(J, T, DIM_SCHEMA, {
        "pk": pk, "g": rng.integers(0, 13, m).astype(np.int32)})
    jf, tf = tables(J, T, (("fk", "INT32", False), ("v", "FLOAT", False)), {
        "fk": rng.integers(0, int((m // dup) * 1.4), n).astype(np.int32),
        "v": rng.random(n, dtype=np.float32)})

    def agg(ns, f, d):
        return ns.GroupAggregate(
            ["g"], [ns.AggSpec(ns.Aggregation.SUM, "v", "sv"),
                    ns.AggSpec(ns.Aggregation.COUNT, None, "c")],
            ns.HashJoin(ns.JoinType.LEFT_OUTER, ["fk"], ["pk"],
                        ns.ScanTable(f), ns.ScanTable(d),
                        getattr(ns.KeyUniqueness, uniq),
                        lhs_projector=ns.Projector.named("v"),
                        rhs_projector=ns.Projector.named("g"),
                        out_capacity=(dup + 1) * n),
            ns.GroupAggregateOptions(estimated_result_row_count=32))

    def p(ns, f, d):
        return agg(ns, f, d) if ordered else ns.Sort(
            [ns.SortKey("sv", False)], agg(ns, f, d))

    got, pushed, direct = _run(p, (jf, jd), (tf, td))
    assert counted == {"J": 1}
    assert None in [r[0] for r in got.to_pylist()]
    _check(got, pushed, direct)


@pytest.mark.parametrize("projectors", [True, False],
                         ids=["bench_plan", "graft_entry_plan"])
def test_headline_through_the_pushdown(counted, projectors):
    """The headline plan at the entry shape (8192 x 1024): the port's rows
    equal the JAX package's through its default binding, the pushdown (by
    key: sums that differ in their last bits may swap two near-equal
    groups under the Sort), and through its direct binding."""
    fact, dim = headline_data(8192, 1024)
    jargs = (jax_table(J, FACT_SCHEMA, fact), jax_table(J, DIM_SCHEMA, dim))
    targs = (torch_table(T, FACT_SCHEMA, fact),
             torch_table(T, DIM_SCHEMA, dim))

    def p(ns, f, d):
        return headline_plan(ns, f, d, projectors)

    got, pushed, direct = _run(p, jargs, targs)
    assert counted == {"J": 1}
    assert _schema(got) == _schema(pushed) == _schema(direct)
    by_key = {r[0]: r for r in pushed.to_pylist()}
    _rows_close(got.to_pylist(), [by_key[r[0]] for r in got.to_pylist()],
                1e-4)
    _rows_close(got.to_pylist(), direct.to_pylist(), 1e-5)
