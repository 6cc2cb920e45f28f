"""The port's aggregate pushdown against the JAX package's, both on the
CPU, mirroring tests/test_agg_pushdown.py: the rewrite (pregroup the probe
side by its join key, join the partials, aggregate again, Sort by first
position when ordered) must fire where the JAX package's fires, give its
rows and the port's own direct binding's rows, with the direct binding's
exact output schema (COUNT a non-nullable UINT64).  Where the rewrite
needs a part the port lacks (the ordered NOT_UNIQUE rewrite, whose join
needs the merge probe; a STRING join key), it declines and the direct
binding answers, or raises as it does without the pushdown.  Each case
sets the binding on the plan (``_pushdown_disabled``), whatever the
port's default."""
import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu.ops.aggregate as JA
import supersonic_tpu_torch as T
import supersonic_tpu_torch.ops.aggregate as TA

from torch_parity import (DIM_SCHEMA, FACT_SCHEMA, headline_data,
                          headline_plan, jax_table, tables, torch_table)

torch.set_num_threads(1)


@pytest.fixture
def counted(monkeypatch):
    """{"J": fired rewrites of the JAX package, "T": of the port}."""
    calls = {"J": 0, "T": 0}
    for key, mod in (("J", JA), ("T", TA)):
        orig = mod.GroupAggregate._try_aggregate_pushdown

        def wrap(self, ctx, uo, orig=orig, key=key):
            r = orig(self, ctx, uo)
            calls[key] += r is not None
            return r

        monkeypatch.setattr(mod.GroupAggregate, "_try_aggregate_pushdown",
                            wrap)
    return calls


def _agg_of(plan):
    return plan.child if isinstance(plan, (J.Sort, T.Sort)) else plan


def _bind(plan, pushdown: bool):
    _agg_of(plan)._pushdown_disabled = not pushdown
    return plan


def _run(plan_fn, jargs, targs):
    """(port through the pushdown, port direct, JAX through the pushdown)."""
    return (T.execute(_bind(plan_fn(T, *targs), True)),
            T.execute(_bind(plan_fn(T, *targs), False)),
            J.execute(_bind(plan_fn(J, *jargs), True)))


def _rows_close(got, want, rtol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if isinstance(x, float):
                assert y is not None and abs(x - y) <= rtol * max(
                    1.0, abs(y)), (a, b)
            else:
                assert x == y, (a, b)


def _check(got, direct, want, nkeys=1):
    """The port's pushdown rows equal the JAX package's pushdown rows and
    the port's direct rows; the schema is the direct binding's."""
    schema = [(a.name, a.type.value, a.nullable) for a in got.schema]
    assert schema == [(a.name, a.type.value, a.nullable)
                      for a in want.schema]
    assert schema == [(a.name, a.type.value, a.nullable)
                      for a in direct.schema]
    _rows_close(got.to_pylist(), want.to_pylist(), 1e-5)
    _rows_close(got.to_pylist(), direct.to_pylist(), 1e-4)


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
    got, direct, want = _run(_plan, jargs, targs)
    assert counted == {"J": 1, "T": 1}, "pushdown did not fire"
    _check(got, direct, want)
    assert got.schema.lookup("c").type == T.UINT64
    assert not got.schema.lookup("c").nullable


def test_pushdown_under_sort_unordered(counted):
    jargs, targs = _data(seed=11)

    def p(ns, f, d):
        return ns.Sort([ns.SortKey("si", ascending=False)], _plan(ns, f, d))

    got, direct, want = _run(p, jargs, targs)
    assert counted == {"J": 1, "T": 1}
    _check(got, direct, want)


def test_pushdown_count_as_sum_and_empty_groups(counted):
    """INNER groups exist only for matched keys; COUNT counts the non-NULL
    inputs, and becomes a SUM of INT32 partial counts into UINT64 (the
    sort path in both packages, at 7 groups)."""
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

    got, direct, want = _run(p, (jf, jd), (tf, td))
    assert counted == {"J": 1, "T": 1}
    assert got.to_pylist() == want.to_pylist() == direct.to_pylist()


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

    got, direct, want = _run(p, (jf, jd), (tf, td))
    assert counted == {"J": 1, "T": 1}
    _check(got, direct, want)
    assert sorted(r[0] for r in got.to_pylist()) == list(words)


def test_pushdown_declines_ineligible(counted):
    """No rewrite in either package for: a probe side too small to shrink,
    group keys from the probe side, aggregate inputs from the build side,
    FIRST (not decomposable)."""
    (jf, jd), (tf, td) = _data(n=4000, m=3000)  # range * 4 > capacity
    for ns, f, d in ((J, jf, jd), (T, tf, td)):
        ns.execute(_bind(_plan(ns, f, d), True))
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

    got = T.execute(_bind(probe_key(T, tf, td), True)).to_pylist()
    want = J.execute(_bind(probe_key(J, jf, jd), True)).to_pylist()
    assert [r[0] for r in got] == [r[0] for r in want]
    fk, v = tf.columns["fk"].values.numpy(), tf.columns["v"].values.numpy()
    sums = np.bincount(fk, weights=v.astype(np.float64))
    np.testing.assert_allclose([r[1] for r in got],
                               [sums[r[0]] for r in got], rtol=1e-6)
    for make in (build_input, first):  # binds only: no row is compared
        _bind(make(T, tf, td), True).bind(T.BindContext())
        _bind(make(J, jf, jd), True).bind(J.BindContext())
    assert counted == {"J": 0, "T": 0}


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

    got, direct, want = _run(p, jargs, targs)
    assert counted == {"J": 1, "T": 1}
    _check(got, direct, want)


def test_ordered_not_unique_pushdown_declines(counted):
    """The ordered NOT_UNIQUE rewrite ranks groups by a computed build
    position, which has no statistics, so its join would need the merge
    probe (ROADMAP.md queue 1 item 7): the port declines and its direct
    binding gives the JAX package's pushdown rows."""
    jargs, targs = _not_unique_data()
    got, direct, want = _run(_not_unique_agg, jargs, targs)
    assert counted == {"J": 1, "T": 0}
    _rows_close(got.to_pylist(), want.to_pylist(), 1e-5)
    assert got.to_pylist() == direct.to_pylist()


def test_string_join_key_pushdown_declines(counted):
    """The JAX package ranges a STRING join key by its dictionary; the
    port's join takes no STRING key (item 11), so the port declines and its
    direct binding raises as it does without the pushdown."""
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

    _bind(p(J, jf, jd), True).bind(J.BindContext())
    with pytest.raises(NotImplementedError, match="item 11"):
        T.execute(_bind(p(T, tf, td), True))
    assert counted == {"J": 1, "T": 0}


@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
@pytest.mark.parametrize("ordered", [True, False])
def test_pushdown_left_outer(counted, uniq, ordered):
    """LEFT_OUTER decomposes too: an unmatched probe row's partial emits
    one NULL-rhs row, so the NULL-key group gets the same partials.  The
    ordered NOT_UNIQUE case declines in the port (item 7)."""
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

    got, direct, want = _run(p, (jf, jd), (tf, td))
    declines = ordered and uniq == "NOT_UNIQUE"
    assert counted == {"J": 1, "T": 0 if declines else 1}
    assert None in [r[0] for r in got.to_pylist()]
    _check(got, direct, want)


@pytest.mark.parametrize("projectors", [True, False],
                         ids=["bench_plan", "graft_entry_plan"])
def test_headline_through_the_pushdown(counted, projectors):
    """The headline plan at the entry shape (8192 x 1024) through the
    pushdown: the JAX package's default binding, rows equal to its rows
    and to the port's direct binding's."""
    fact, dim = headline_data(8192, 1024)
    jargs = (jax_table(J, FACT_SCHEMA, fact), jax_table(J, DIM_SCHEMA, dim))
    targs = (torch_table(T, FACT_SCHEMA, fact),
             torch_table(T, DIM_SCHEMA, dim))

    def p(ns, f, d):
        return headline_plan(ns, f, d, projectors)

    got, direct, want = _run(p, jargs, targs)
    assert counted == {"J": 1, "T": 1}
    by_key = {r[0]: r for r in direct.to_pylist()}
    _rows_close(sorted(got.to_pylist()), sorted(want.to_pylist()), 1e-5)
    _rows_close(got.to_pylist(), [by_key[r[0]] for r in got.to_pylist()],
                1e-4)
