"""The JAX suite's scenarios that no other port test replays, and a seeded
random-plan cross-check, on the CPU.

Each case names the JAX test it mirrors and runs the same plan over the
same data: against the JAX test's own expected values, or against the JAX
package live where the JAX test has none of its own (error messages,
cancellation poll counts, random plans).

- Cancellation (tests/test_errors.py): the port polls a token that
  overrides ``interrupted()`` (the reference's ``Cursor::Interrupt`` hooked
  to an outside flag) where the JAX package does, as often.
- The public-API scenarios of tests/test_errors.py, test_sort.py,
  test_guide.py, test_exprs.py, test_tz.py, test_native.py and
  test_api_surface.py that no other ``test_torch_*.py`` holds.
- Seeded random plans (tests/torch_fuzz.py, shared with chip_smoke.py's
  phase (am)) through both packages.

Left out, and why:
- tests/test_agg_pushdown.py's asserts that the pushdown fires: the port
  has no pushdown and binds every aggregate over a join directly (the
  rewrite measured slower on the card); its rows are held to the JAX
  package's under both of its bindings in tests/test_torch_pushdown.py.
- Tests of JAX internals: test_exprs.py::
  test_constant_subtrees_fold_in_compiled_hlo (XLA's HLO; the port's
  folding is held in test_torch_exprs_extended.py),
  test_capacity_edges.py's ``_APPROX_TOPK_MAX_CAP`` branch, and the
  ``jax.jit``, ``jnp``-input, ``_group_concat_fast``, ``_fmt_double`` and
  Pallas interpret-mode tests.
- test_api_surface.py::test_every_reference_public_factory_exists reads
  the reference's C++ headers, which are not in the repository (it skips
  there too); test_torch_conformance.py holds the port's names against
  the JAX package's.
- test_tz.py's local fields, tables and host shift: held in
  test_torch_exprs_extended.py.

Run alone: ``python -m pytest tests/test_torch_jax_suite.py -q -p
no:xdist`` (one torch thread, ~30 s).
"""
from __future__ import annotations

import ast
import datetime
import math
import pathlib
import zoneinfo

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
import torch_fuzz as F
from torch_parity import tables

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def tbl(schema, data, **kw):
    """A port table on the CPU from Python lists (None = NULL)."""
    return T.Table.from_data(schema, data, device="cpu", **kw)


def raised(fn):
    """(exception type name, message) that ``fn()`` raises."""
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


# ---------------------------------------------------------------------------
# tests/test_errors.py: cancellation (fault 6) and the failure model
# ---------------------------------------------------------------------------

POLL_ROWS = 5000
POLL_WORDS = tuple(f"w{i:03d}" for i in range(50))
# the JAX package's poll counts over the data of ``poll_tables``
EXPECTED_POLLS = {"spill_sort": 71, "hybrid": 86, "render": 3, "filter": 2}


@pytest.fixture(scope="module")
def poll_tables():
    """(JAX table, port table): k INT64 descending, v INT64, s STRING."""
    rng = np.random.default_rng(0)
    return tables(
        J, T, (("k", "INT64", False), ("v", "INT64", False),
               ("s", "STRING", False)),
        {"k": np.arange(POLL_ROWS, dtype=np.int64)[::-1].copy(),
         "v": rng.integers(0, 100, POLL_ROWS).astype(np.int64),
         "s": rng.integers(0, len(POLL_WORDS), POLL_ROWS).astype(np.int32)},
        {"s": POLL_WORDS})


def poll_plan(ns, t, name, tmp):
    """The spilling sort (memory_limit 4096), the spilling hybrid group-by
    (memory_quota 2048), a deferred host render and a plain Filter."""
    if name == "spill_sort":
        return ns.SortWithTempDirPrefix(
            [("k", True)], ns.ScanTable(t), memory_limit=4096,
            temporary_directory_prefix=str(tmp))
    if name == "hybrid":
        return ns.HybridGroupAggregate(
            ["k"], [ns.AggSpec(ns.Aggregation.SUM, "v", "sv")],
            ns.ScanTable(t), ns.GroupAggregateOptions(memory_quota=2048),
            temporary_directory_prefix=str(tmp))
    if name == "render":
        return ns.Compute([ns.ToString(ns.col("v")).as_("r")],
                          ns.ScanTable(t))
    return ns.Filter(ns.col("v") > 50, ns.ScanTable(t))


def flip_after(ns, n):
    """tests/test_errors.py:62-72's FlipAfter over package ``ns``: its
    ``interrupted()`` turns true at the (n + 1)-th poll; it counts its
    polls.  ``n`` None: never."""
    class FlipAfter(ns.CancellationToken):
        __slots__ = ("n", "polls")

        def __init__(self):
            super().__init__()
            self.n, self.polls = n, 0

        def interrupted(self):
            self.polls += 1
            if self.n is None:
                return False
            self.n -= 1
            return self.n < 0
    return FlipAfter()


@pytest.mark.parametrize("name", list(EXPECTED_POLLS))
def test_poll_count_matches_jax(poll_tables, name, tmp_path):
    """tests/test_errors.py::test_cancellation_mid_spill's token, counting
    its polls and never firing: the port reads ``interrupted()`` where the
    JAX package does, as often."""
    polls = []
    for ns, t in zip((J, T), poll_tables):
        token = flip_after(ns, None)
        ns.execute(poll_plan(ns, t, name, tmp_path), cancel=token)
        polls.append(token.polls)
    assert polls == [EXPECTED_POLLS[name]] * 2
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["spill_sort", "hybrid"])
def test_flip_after_interrupts_the_spill_in_both(poll_tables, name,
                                                 tmp_path):
    """tests/test_errors.py::test_cancellation_mid_spill: FlipAfter(3)
    stops the spilling plan between chunks in both packages, leaving no
    file behind; the uninterrupted rerun gives the same rows (the sort's
    first ones 0, 1, 2, 3)."""
    rows = []
    for ns, t in zip((J, T), poll_tables):
        token = flip_after(ns, 3)
        with pytest.raises(ns.Interrupted):
            ns.execute(poll_plan(ns, t, name, tmp_path), cancel=token)
        assert token.polls == 4
        assert not list(tmp_path.iterdir())
        rows.append(ns.execute(poll_plan(ns, t, name, tmp_path))
                    .to_pylist())
    assert rows[1] == rows[0]
    if name == "spill_sort":
        assert [r[0] for r in rows[1][:4]] == [0, 1, 2, 3]


@pytest.mark.parametrize("name", ["filter", "hybrid"])
def test_pre_interrupted_token_fails_in_both(poll_tables, name, tmp_path):
    """tests/test_errors.py::test_cancellation_before_dispatch: a token
    interrupted before the query fails it at the first poll."""
    for ns, t in zip((J, T), poll_tables):
        token = ns.CancellationToken()
        token.interrupt()
        with pytest.raises(ns.Interrupted, match="query interrupted"):
            ns.execute(poll_plan(ns, t, name, tmp_path), cancel=token)


def test_bind_context_polls_its_token():
    """The JAX package's ``BindContext.check_cancel``: a no-op without a
    token, the token's poll with one."""
    from supersonic_tpu_torch.ops.base import BindContext

    BindContext().check_cancel()
    token = flip_after(T, 0)
    with pytest.raises(T.Interrupted):
        BindContext(token).check_cancel()
    assert token.polls == 1


def error_plan(name):
    """The plans of tests/test_errors.py's four failure tests."""
    kv = tbl(T.TupleSchema.of(("k", T.INT64), ("v", T.INT64)),
             {"k": [1, 2, 3, 4], "v": [1, 1, 1, 1]})
    if name == "missing_column":
        return T.Project(T.Projector.named("zz"), T.ScanTable(kv))
    if name == "non_bool_predicate":
        return T.Filter(T.col("k") + 1, T.ScanTable(kv))
    if name == "aggregate_overflow":
        return T.GroupAggregate(
            ["k"], [T.AggSpec(T.Aggregation.SUM, "v", "s")], T.ScanTable(kv),
            T.GroupAggregateOptions(estimated_result_row_count=2))
    lhs = tbl(T.TupleSchema.of(("k", T.INT64),), {"k": [7, 7]})
    rhs = tbl(T.TupleSchema.of(("k2", T.INT64),), {"k2": [7, 7, 7]})
    return T.HashJoin(T.JoinType.INNER, ["k"], ["k2"], T.ScanTable(lhs),
                      T.ScanTable(rhs), T.KeyUniqueness.NOT_UNIQUE,
                      out_capacity=4)


@pytest.mark.parametrize("name,error,message", [
    ("missing_column", "SchemaError", None),
    ("non_bool_predicate", "TypeError_", None),
    ("aggregate_overflow", "EvaluationError",
     "evaluation failed: aggregate result overflow"),
    ("join_overflow", "EvaluationError",
     "evaluation failed: join result overflow")])
def test_failure_case(name, error, message):
    """tests/test_errors.py's test_missing_column_is_bind_error,
    test_non_bool_filter_predicate, test_aggregate_capacity_overflow_flags
    and test_join_overflow_flags: the exception the JAX test expects, with
    the JAX package's whole message for the two overflow flags."""
    got = raised(lambda: T.execute(error_plan(name)))
    assert got[0] == error
    assert message is None or got[1] == message


# ---------------------------------------------------------------------------
# tests/test_sort.py
# ---------------------------------------------------------------------------

def sort_table(capacity=None):
    """tests/test_sort.py::make_table."""
    return tbl(T.TupleSchema.of(("a", T.INT64), ("b", T.DOUBLE),
                                ("s", T.STRING)), {
        "a": [3, 1, None, 2, 1],
        "b": [1.0, -2.5, 3.0, None, 0.0],
        "s": ["beta", "alpha", "delta", None, "alpha"]}, capacity=capacity)


def sort_case(name):
    """(plan, the rows the JAX test expects: one column, or pairs)."""
    t, K = sort_table(), T.SortKey
    if name == "single_key_asc_nulls_first":
        return T.Sort(["a"], T.ScanTable(t)), [None, 1, 1, 2, 3]
    if name == "single_key_desc_nulls_last":
        return (T.Sort([K("a", ascending=False)], T.ScanTable(t)),
                [3, 2, 1, 1, None])
    if name == "two_keys":
        return (T.Sort([("a", True), ("b", False)], T.ScanTable(t)),
                [(None, 3.0), (1, 0.0), (1, -2.5), (2, None), (3, 1.0)])
    if name == "stability":
        s = tbl(T.TupleSchema.of(("k", T.INT64), ("v", T.INT64)),
                {"k": [1, 1, 1, 0], "v": [10, 20, 30, 40]})
        return T.Sort(["k"], T.ScanTable(s)), [(0, 40), (1, 10), (1, 20),
                                                (1, 30)]
    if name == "string_sort":
        return T.Project(T.Projector.named("s"), T.Sort(
            ["s"], T.ScanTable(t))), [None, "alpha", "alpha", "beta",
                                      "delta"]
    if name == "extended_sort_limit":
        return T.ExtendedSort(["a"], T.ScanTable(t), limit=2), [None, 1]
    if name == "extended_sort_case_insensitive":
        s = tbl(T.TupleSchema.of(("s", T.STRING),), {"s": ["b", "A", "a",
                                                           "B"]})
        return (T.ExtendedSort([K("s", case_sensitive=False)],
                               T.ScanTable(s)), ["A", "a", "b", "B"])
    if name.startswith("padding"):
        s = tbl(T.TupleSchema.of(("a", T.INT64),), {"a": [5, 2, 9]},
                capacity=16 if name.endswith("16") else None)
        return T.Sort([("a", True)], T.ScanTable(s)), [2, 5, 9]
    assert name == "result_projector"
    return (T.Sort(["a"], T.ScanTable(t),
                   result_projector=T.Projector([("b", "bb")])),
            [3.0, -2.5, 0.0, None, 1.0])


@pytest.mark.parametrize("name", [
    "single_key_asc_nulls_first", "single_key_desc_nulls_last", "two_keys",
    "stability", "string_sort", "extended_sort_limit",
    "extended_sort_case_insensitive", "padding_none", "padding_16",
    "result_projector"])
def test_sort_case(name):
    """tests/test_sort.py's test_single_key_asc_nulls_first,
    test_single_key_desc_nulls_last, test_two_keys, test_stability,
    test_string_sort, test_extended_sort_limit,
    test_extended_sort_case_insensitive, test_sort_with_padding[None, 16]
    and test_sort_result_projector: the JAX test's expected rows (its
    first column, or the pairs it checks)."""
    plan, want = sort_case(name)
    out = T.execute(plan)
    rows = out.to_pylist()
    if isinstance(want[0], tuple):
        rows = [r[:2] for r in rows]
    else:
        rows = [r[0] for r in rows]
    assert rows == want
    if name == "result_projector":
        assert out.schema.names() == ("bb",)


def test_sort_float_negatives_and_zero():
    """tests/test_sort.py::test_float_negatives_and_zero."""
    t = tbl(T.TupleSchema.of(("x", T.DOUBLE),),
            {"x": [0.0, -0.0, -1.5, 2.0, -3.0]})
    vals = [r[0] for r in T.execute(T.Sort(["x"], T.ScanTable(t)))
            .to_pylist()]
    assert vals[:2] == [-3.0, -1.5] and vals[4] == 2.0
    assert set(vals[2:4]) == {0.0}


def test_extended_sort_limit_topk_path():
    """tests/test_sort.py::test_extended_sort_limit_topk_path: a limit far
    below the capacity gives the full sort's first rows, NULLs and ties
    included."""
    rng = np.random.default_rng(13)
    n = 300
    vals = [None if rng.random() < 0.15 else int(v)
            for v in rng.integers(0, 40, n)]
    t = tbl(T.TupleSchema.of(("a", T.DataType.INT64, True),
                             ("tag", T.DataType.INT64)),
            {"a": vals, "tag": list(range(n))})
    keys = [T.SortKey("a", ascending=False)]
    got = T.execute(T.ExtendedSort(keys, T.ScanTable(t), limit=7))
    full = T.execute(T.ExtendedSort(keys, T.ScanTable(t)))
    assert got.to_pylist() == full.to_pylist()[:7]


# ---------------------------------------------------------------------------
# tests/test_guide.py: the reference's tutorial queries
# ---------------------------------------------------------------------------

def test_guide_primer_addition():
    """tests/test_guide.py::test_primer_addition (primer.cc)."""
    a, b = [3, 4, 7, 10, -3], [5, 3, -2, -10, 0]
    t = tbl(T.TupleSchema.of(("a", T.DataType.INT32, False),
                             ("b", T.DataType.INT32, False)),
            {"a": a, "b": b})
    out = T.execute(T.Compute(T.AttributeAt(0) + T.AttributeAt(1),
                              T.ScanTable(t)))
    assert [r[0] for r in out.to_pylist()] == [x + y for x, y in zip(a, b)]


def test_guide_primer_grouped_sums():
    """tests/test_guide.py::test_primer_grouped_sums (primer.cc
    GroupedSums)."""
    keys = [1, 2, 3, 1, 2, 3, 1, 2]
    data = [1.5, 3.0, 3.0, 7.6, 5.5, 2.0, 1.6, 9.5]
    want: dict = {}
    for k, d in zip(keys, data):
        want[k] = want.get(k, 0.0) + d
    t = tbl(T.TupleSchema.of(("key", T.DataType.INT32, False),
                             ("data", T.DataType.DOUBLE, False)),
            {"key": keys, "data": data})
    out = T.execute(T.GroupAggregate(
        ["key"], [T.AggSpec(T.Aggregation.SUM, "data", "data_sums")],
        T.ScanTable(t)))
    assert out.schema.names() == ("key", "data_sums")
    rows = out.to_pylist()
    assert len(rows) == 3
    for k, s in rows:
        assert s == pytest.approx(want[k])


def test_guide_group_sort_grouping():
    """tests/test_guide.py::test_group_sort_grouping (group_sort.cc
    GroupingTest): GROUP BY (full_time, department) -> MIN(salary),
    MAX(age)."""
    names = ["John", "Darrel", "Greg", "Amanda", "Stacy"]
    ages = [20, 25, 32, 31, 33]
    salaries = [1800, 3300, 4800, 3500, 1900]
    depts = ["Accounting", "Sales", "Sales", "IT", "IT"]
    full_time = [False, True, False, True, False]
    D = T.DataType
    t = tbl(T.TupleSchema.of(
        ("name", D.STRING, False), ("age", D.INT32, False),
        ("salary", D.INT32, False), ("department", D.STRING, False),
        ("full_time", D.BOOL, False)), {
        "name": names, "age": ages, "salary": salaries,
        "department": depts, "full_time": full_time})
    out = T.execute(T.GroupAggregate(
        ["full_time", "department"],
        [T.AggSpec(T.Aggregation.MIN, "salary", "min_salary"),
         T.AggSpec(T.Aggregation.MAX, "age", "max_age")], T.ScanTable(t)))
    golden: dict = {}
    for a, s, d, f in zip(ages, salaries, depts, full_time):
        g = golden.setdefault((f, d), [s, a])
        g[0], g[1] = min(g[0], s), max(g[1], a)
    rows = out.to_pylist()
    assert len(rows) == len(golden)
    for f, d, mn, mx in rows:
        assert golden[(f, d)] == [mn, mx]


@pytest.mark.parametrize("row_count", [12, 300])
def test_guide_group_sort_sorting(row_count):
    """tests/test_guide.py::test_group_sort_sorting (group_sort.cc
    SortingTest): ORDER BY grade over (id, grade)."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 1000, row_count).astype(np.int32)
    grades = np.round(rng.random(row_count) * 5, 2)
    t = tbl(T.TupleSchema.of(("id", T.DataType.INT32, False),
                             ("grade", T.DataType.DOUBLE, False)),
            {"id": ids, "grade": grades})
    got = T.execute(T.Sort(["grade"], T.ScanTable(t))).to_pylist()
    assert [g for _, g in got] == sorted(grades.tolist())
    assert sorted(got) == sorted(zip(ids.tolist(), grades.tolist()))


def test_guide_join_books_authors():
    """tests/test_guide.py::test_join_books_authors (join.cc HashJoinTest):
    books INNER JOIN authors, NULL and missing refs never match."""
    D = T.DataType
    authors = tbl(T.TupleSchema.of(
        ("author_id", D.INT32, False), ("name", D.STRING, False),
        ("nobel", D.BOOL, False)), {
        "author_id": [1, 2, 3], "name": ["Tolkien", "Lem", "Dick"],
        "nobel": [False, False, False]})
    books = tbl(T.TupleSchema.of(
        ("book_id", D.INT32, False), ("author_id_ref", D.INT32, True),
        ("title", D.STRING, False), ("date_published", D.DATE, True)), {
        "book_id": [10, 11, 12, 13], "author_id_ref": [2, 1, None, 9],
        "title": ["Solaris", "The Hobbit", "Anonymous", "Orphan"],
        "date_published": [100, 200, None, 300]})
    out = T.execute(T.HashJoin(
        T.JoinType.INNER, ["author_id_ref"], ["author_id"],
        T.ScanTable(books), T.ScanTable(authors), T.KeyUniqueness.UNIQUE,
        lhs_projector=T.Projector.named("title", "date_published"),
        rhs_projector=T.Projector([("name", "author_name"),
                                   ("nobel", None)])))
    assert out.schema.names() == ("title", "date_published", "author_name",
                                  "nobel")
    assert out.to_pylist() == [("Solaris", 100, "Lem", False),
                               ("The Hobbit", 200, "Tolkien", False)]


# ---------------------------------------------------------------------------
# tests/test_exprs.py
# ---------------------------------------------------------------------------

def eval_expr(expr, data=None, schema=None):
    """tests/test_exprs.py::eval_expr on the port."""
    schema = schema or T.TupleSchema.of(
        ("a", T.INT64), ("b", T.INT64), ("x", T.DOUBLE), ("p", T.BOOL),
        ("q", T.BOOL))
    data = data or {"a": [1, 2, None, 4], "b": [10, None, 30, 40],
                    "x": [0.5, 1.5, 2.5, None], "p": [True, False, None, True],
                    "q": [None, False, True, False]}
    out = T.execute(T.Compute(expr, T.ScanTable(tbl(schema, data))))
    return [r[0] for r in out.to_pylist()]


def one(name, typ, values):
    """(data, schema) of a single column."""
    return {name: values}, T.TupleSchema.of((name, typ),)


EXPR_CASES = {
    # name: (expression builder, (data, schema) or None, expected values)
    "plus_nulls": (lambda: T.col("a") + T.col("b"), None,
                   [11, None, None, 44]),
    "literal_sugar": (lambda: T.col("a") * 2, None, [2, 4, None, 8]),
    "divide_nulling_by_zero": (
        lambda: T.DivideNulling(T.col("a"), T.Const(0)), None, [None] * 4),
    "divide_nulling": (lambda: T.DivideNulling(T.col("b"), T.Const(4)),
                       None, [2.5, None, 7.5, 10.0]),
    "less": (lambda: T.col("a") < T.col("b"), None, [True, None, None, True]),
    "equal": (lambda: T.col("a").eq(T.Const(2)), None,
              [False, True, None, False]),
    "ternary_and": (lambda: T.col("p") & T.col("q"), None,
                    [None, False, None, False]),
    "ternary_or": (lambda: T.col("p") | T.col("q"), None,
                   [True, False, True, True]),
    "not": (lambda: ~T.col("p"), None, [False, True, None, False]),
    "is_null": (lambda: T.IsNull(T.col("a")), None,
                [False, False, True, False]),
    "if_null": (lambda: T.IfNull(T.col("a"), T.Const(0)), None,
                [1, 2, 0, 4]),
    "if": (lambda: T.If(T.col("p"), T.col("a"), T.col("b")), None,
           [1, None, 30, 4]),
    "case": (lambda: T.Case(T.col("a"), T.Const(-1), T.Const(1),
                            T.Const(100), T.Const(2), T.Const(200)), None,
             [100, 200, -1, -1]),
    "in": (lambda: T.In(T.col("a"), T.Const(1), T.Const(4)), None,
           [True, False, None, True]),
    "cast": (lambda: T.CastTo(T.DataType.DOUBLE, T.col("a")), None,
             [1.0, 2.0, None, 4.0]),
    "sequence": (lambda: T.Sequence(), one("a", T.INT64, [5, 6, 7]),
                 [0, 1, 2]),
    "null_literal": (lambda: T.Null(T.DataType.INT64), None, [None] * 4),
    "string_equal": (lambda: T.col("s").eq(T.Const("x")),
                     one("s", T.STRING, ["x", "y", None, "x"]),
                     [True, False, None, True]),
    "parse_string": (
        lambda: T.ParseStringNulling(T.DataType.INT64, T.col("s")),
        one("s", T.STRING, ["12", "oops", None, "-3"]), [12, None, None, -3]),
    "string_unify_if": (
        lambda: T.If(T.col("p"), T.col("s"), T.col("t")),
        ({"p": [True, False, True], "s": ["a", "b", "c"],
          "t": ["z", "y", "x"]},
         T.TupleSchema.of(("p", T.BOOL), ("s", T.STRING), ("t", T.STRING))),
        ["a", "y", "c"]),
    "modulus": (lambda: T.col("b") % T.Const(7), None, [3, None, 2, 5]),
    "modulus_truncates": (lambda: T.col("a") % T.Const(3),
                          one("a", T.INT64, [-7]), [-1]),
    "cpp_division_truncates": (
        lambda: T.CppDivide(T.col("a"), T.Const(2)),
        one("a", T.INT64, [-3, 3, -4]), [-1, 1, -2]),
}


@pytest.mark.parametrize("name", list(EXPR_CASES))
def test_expression_case(name):
    """tests/test_exprs.py's test_plus_nulls, test_literal_sugar,
    test_divide_nulling, test_comparisons, test_ternary_and,
    test_ternary_or, test_not, test_is_null_if_null, test_if, test_case,
    test_in, test_cast, test_sequence, test_null_literal,
    test_string_equal, test_parse_string, test_string_unify_if,
    test_modulus and test_cpp_division_truncates_toward_zero: the JAX
    test's expected values, NULLs included."""
    make, given, want = EXPR_CASES[name]
    data, schema = given or (None, None)
    assert eval_expr(make(), data, schema) == want


def test_expression_arith_promotion():
    """tests/test_exprs.py::test_arith_promotion: INT64 + DOUBLE."""
    vals = eval_expr(T.col("a") + T.col("x"))
    assert vals[0] == pytest.approx(1.5) and vals[3] is None


def test_expression_divide_signaling_raises():
    """tests/test_exprs.py::test_divide_signaling_raises."""
    got = raised(lambda: eval_expr(T.col("a") / (T.col("a") - T.col("a"))))
    assert got == ("EvaluationError", "evaluation failed: division by zero")


# ---------------------------------------------------------------------------
# tests/test_tz.py, against the port's own exprs/tz.py
# ---------------------------------------------------------------------------

@pytest.fixture
def local_tz():
    """Set the port's local timezone; the default after."""
    yield T.set_local_timezone
    T.set_local_timezone(None)


def dt_table(secs):
    return tbl(T.TupleSchema.of(("t", T.DataType.DATETIME)),
               {"t": [int(s) * 1_000_000 for s in secs]})


def compute_rows(exprs, table):
    out = T.execute(T.Compute(exprs, T.ScanTable(table)))
    names = [a.name for a in out.schema]
    return [dict(zip(names, r)) for r in out.to_pylist()]


def test_tz_local_is_utc_by_default(local_tz):
    """tests/test_tz.py::test_local_is_utc_by_default."""
    from supersonic_tpu_torch.exprs import tz

    local_tz("UTC")
    assert tz.current_tables() is None
    rows = compute_rows([T.HourLocal(T.col("t")).as_("h")],
                        dt_table([3600 * 5]))
    assert rows[0]["h"] == 5


def test_tz_dateformat_utc_formats():
    """tests/test_tz.py::test_dateformat_utc_formats."""
    secs = [0, 86399, 86400, 1700000000]
    dom = (0, 1700000000 * 1_000_000)
    rows = compute_rows(
        [T.DateFormat(T.col("t"), "%Y/%m/%d", domain=dom).as_("d"),
         T.DateFormat(T.col("t"), "%Y-%m-%d %H", domain=dom).as_("h")],
        dt_table(secs))
    for sec, r in zip(secs, rows):
        utc = datetime.datetime(1970, 1, 1) + datetime.timedelta(seconds=sec)
        assert r["d"] == utc.strftime("%Y/%m/%d")
        assert r["h"] == utc.strftime("%Y-%m-%d %H")


def test_tz_dateformat_granule_inference():
    """tests/test_tz.py::test_dateformat_granule_inference."""
    from supersonic_tpu_torch.exprs.date import _format_granule_sec

    assert _format_granule_sec("%Y/%m/%d") == 86_400
    assert _format_granule_sec("%H o'clock") == 3600
    assert _format_granule_sec("%R") == 60
    assert _format_granule_sec("%T") == 1
    assert _format_granule_sec("100%% %d") == 86_400


def test_tz_dateformat_dictionary_dedups():
    """tests/test_tz.py::test_dateformat_dictionary_dedups: "%H:%M" over
    three days binds 1440 distinct strings, sorted."""
    b = T.DateFormat(T.col("t"), "%H:%M", domain=(
        0, 3 * 86400 * 1_000_000)).bind(
        T.TupleSchema.of(("t", T.DataType.DATETIME)), {})
    assert len(b.dictionary) == 1440
    assert b.dictionary.is_sorted()


def test_tz_dateformat_over_32_chars_is_empty():
    """tests/test_tz.py::test_dateformat_over_32_chars_is_empty (the
    reference's 33-byte buffer)."""
    fmt = "the %Y year of %B the month of it"
    rows = compute_rows([T.DateFormat(T.col("t"), fmt, domain=(
        0, 86400 * 1_000_000)).as_("f")], dt_table([100]))
    assert rows[0]["f"] == ""


def test_tz_dateformat_local_dst(local_tz):
    """tests/test_tz.py::test_dateformat_local_dst: America/New_York
    around both 2024 switches, against zoneinfo."""
    local_tz("America/New_York")
    z = zoneinfo.ZoneInfo("America/New_York")
    secs = [1710050399, 1710054000, 1730613599, 1730613600]
    rows = compute_rows([T.DateFormatLocal(
        T.col("t"), "%Y-%m-%d %H:%M",
        domain=(min(secs) * 1_000_000, max(secs) * 1_000_000)).as_("f")],
        dt_table(secs))
    for sec, r in zip(secs, rows):
        assert r["f"] == datetime.datetime.fromtimestamp(sec, z).strftime(
            "%Y-%m-%d %H:%M"), sec


def test_tz_dateformat_date_input():
    """tests/test_tz.py::test_dateformat_date_input: DATE days, NULL
    kept."""
    t = tbl(T.TupleSchema.of(("d", T.DataType.DATE)),
            {"d": [0, 11016, None]})
    rows = compute_rows([T.DateFormat(T.col("d"), "%a %Y-%j",
                                      domain=(0, 24800)).as_("f")], t)
    assert rows[0]["f"] == "Thu 1970-001"
    assert rows[1]["f"] == (datetime.date(1970, 1, 1) + datetime.timedelta(
        days=11016)).strftime("%a %Y-%j")
    assert rows[2]["f"] is None


def test_tz_dateformat_out_of_domain_raises():
    """tests/test_tz.py::test_dateformat_out_of_domain_raises."""
    with pytest.raises(T.EvaluationError):
        T.execute(T.Compute([T.DateFormat(
            T.col("t"), "%Y", domain=(0, 86400 * 1_000_000)).as_("f")],
            T.ScanTable(dt_table([2 * 86400]))))


def test_tz_dateformat_rejects_nonconst_and_over_budget():
    """tests/test_tz.py::test_dateformat_rejects_nonconst_and_over_budget:
    no domain binds (deferred render); a column format and a domain past
    the budget raise."""
    schema = T.TupleSchema.of(("t", T.DataType.DATETIME))
    assert T.DateFormat(T.col("t"), "%Y").bind(schema, {}).type == \
        T.DataType.STRING
    with pytest.raises(T.types.TypeError_):
        T.DateFormat(T.col("t"), T.col("t"))
    with pytest.raises(T.types.TypeError_):
        T.DateFormat(T.col("t"), "%T",
                     domain=(0, 2**31 * 1_000_000)).bind(schema, {})


def test_tz_dateformat_local_rejects_zone_directives(local_tz):
    """tests/test_tz.py::test_dateformat_local_rejects_zone_directives."""
    local_tz("America/New_York")
    with pytest.raises(T.types.TypeError_):
        T.DateFormatLocal(T.col("t"), "%H %Z", domain=(0, 10**9)).bind(
            T.TupleSchema.of(("t", T.DataType.DATETIME)), {})


def test_tz_tables_cover_32bit_time_t():
    """tests/test_tz.py::test_tz_tables_cover_32bit_time_t: a day each over
    32-bit time_t, more than 100 switches, at most one a day."""
    from supersonic_tpu_torch.exprs import tz

    tt = tz._compile("America/New_York")
    assert tt is not None and len(tt.off_before) == tz.NDAYS
    assert (tt.switch_sec != 86400).sum() > 100


# ---------------------------------------------------------------------------
# tests/test_native.py and tests/test_api_surface.py
# ---------------------------------------------------------------------------

def test_native_builds():
    """tests/test_native.py::test_native_builds: the port's C++ helpers
    (a dictionary encoder among them) build with g++."""
    from supersonic_tpu_torch import native

    assert native.available()


def test_native_encode_matches_python():
    """tests/test_native.py::test_native_encode_matches_python: 10000
    values (the native path) with NULLs, against a sorted dictionary made
    in Python."""
    from supersonic_tpu_torch.dictionary import encode

    rng = np.random.default_rng(0)
    vocab = [f"word{i:04d}" for i in range(300)]
    values = [vocab[i] if i % 17 else None
              for i in rng.integers(0, 300, 10000)]
    codes, valid, d = encode(values)
    present = sorted({v for v in values if v is not None})
    assert list(d.values) == present
    index = {v: i for i, v in enumerate(present)}
    for i, v in enumerate(values):
        assert (not valid[i]) if v is None else codes[i] == index[v]


def test_native_encode_bytes():
    """tests/test_native.py::test_native_encode_bytes."""
    from supersonic_tpu_torch.dictionary import encode

    codes, valid, d = encode([b"b", b"a", None, b"b"] * 2000)
    assert list(d.values) == [b"a", b"b"]
    assert codes[0] == 1 and codes[1] == 0 and not valid[2]


S1 = T.TupleSchema.of(("x", T.DataType.DOUBLE), ("s", T.DataType.STRING))
D1 = {"x": [90.0, 180.0], "s": ["Alpha", "beta"]}


def surface_rows(exprs):
    return compute_rows(exprs, tbl(S1, D1))


def test_surface_math_factories():
    """tests/test_api_surface.py::test_math_compat_factories."""
    rows = surface_rows([
        T.Pi().as_("pi"), T.ToRadians(T.col("x")).as_("rad"),
        T.ToDegrees(T.ToRadians(T.col("x"))).as_("deg"),
        T.RandomDouble(seed=7).as_("rnd")])
    assert rows[0]["pi"] == pytest.approx(math.pi)
    assert rows[0]["rad"] == pytest.approx(math.pi / 2)
    assert rows[1]["deg"] == pytest.approx(180.0)
    assert 0.0 <= rows[0]["rnd"] < 1.0 and rows[0]["rnd"] != rows[1]["rnd"]


def test_surface_string_factories():
    """tests/test_api_surface.py::test_string_compat_factories."""
    rows = surface_rows([
        T.ConcatWithSeparator("-", T.col("s"), T.col("s"), T.col("s"))
        .as_("c"),
        T.StringContainsCI(T.col("s"), T.Const("ALPHA")).as_("ci"),
        T.TrailingSubstring(T.col("s"), T.Const(3)).as_("ts")])
    assert rows[0]["c"] == "Alpha-Alpha-Alpha"
    assert rows[0]["ci"] is True and rows[1]["ci"] is False
    assert rows[0]["ts"] == "pha"


def test_surface_terminal_factories():
    """tests/test_api_surface.py::test_terminal_compat_factories."""
    rows = surface_rows([T.TypedConst(T.DataType.INT64, 42).as_("tc"),
                         T.ConstBinary(b"ab").as_("cb"),
                         T.ConstDataType(T.DataType.INT32).as_("cd")])
    assert rows[0]["tc"] == 42 and rows[0]["cb"] == b"ab"
    assert isinstance(rows[0]["cd"], int)


def test_surface_datetime_factories():
    """tests/test_api_surface.py::test_datetime_compat_factories."""
    rows = surface_rows([
        T.Day(T.ConstDateTimeFromSecondsSinceEpoch(86400)).as_("d"),
        T.Hour(T.ConstDateTimeFromMicrosecondsSinceEpoch(
            7200 * 1_000_000)).as_("h"),
        T.Day(T.AddDay(T.ConstDateTimeFromSecondsSinceEpoch(0))).as_("ad")])
    assert (rows[0]["d"], rows[0]["h"], rows[0]["ad"]) == (2, 2, 2)
    assert 0 <= surface_rows([T.Hour(T.Now()).as_("h")])[0]["h"] < 24
    with pytest.raises(T.types.TypeError_):
        T.ParseDateTime("%Y", T.col("s"))


def test_surface_hashing_factories():
    """tests/test_api_surface.py::test_hashing_compat_factories."""
    rows = surface_rows([
        T.SupersonicFingerprint(T.col("x")).as_("f"),
        T.SupersonicHash(T.col("x"), T.Const(7)).as_("h1"),
        T.SupersonicHash(T.col("x"), T.Const(8)).as_("h2")])
    assert rows[0]["f"] != rows[1]["f"] and rows[0]["h1"] != rows[0]["h2"]


def test_surface_projection_factories():
    """tests/test_api_surface.py::test_projection_compat_factories."""
    rows = surface_rows([T.InputAttributeProjection(
        T.Projector.rename({"x": "y"}))])
    assert rows[0]["y"] == 90.0
    assert len(T.InputAttributeProjection(["x", "s"])) == 2
    rows = surface_rows([T.Projection([T.col("x")],
                                      T.Projector([(0, "renamed")]))])
    assert rows[0]["renamed"] == 90.0


def test_surface_operation_factories(tmp_path):
    """tests/test_api_surface.py::test_operation_compat_factories."""
    t = tbl(T.TupleSchema.of(("g", T.DataType.INT64), ("v", T.DataType.INT64)),
            {"g": [1, 1, 2], "v": [10, 20, 30]})
    out = T.execute(T.AggregateClustersWithSpecifiedOutputBlockSize(
        ["g"], [T.AggSpec(T.Aggregation.SUM, "v", "sv")], 16, T.ScanView(t)))
    assert out.to_pylist() == [(1, 30), (2, 30)]
    out = T.execute(T.SortWithTempDirPrefix(
        [T.SortKey("v", ascending=False)], T.ScanView(t),
        temporary_directory_prefix=str(tmp_path)))
    assert [r[1] for r in out.to_pylist()] == [30, 20, 10]


# ---------------------------------------------------------------------------
# Seeded random plans (tests/torch_fuzz.py), the JAX package against the port
# ---------------------------------------------------------------------------

FUZZ_SIZES = (0, 1, 2, 7, 33, 100, 517)
FUZZ_SEEDS = 28  # four plans of each family


@pytest.mark.parametrize("seed", range(FUZZ_SEEDS))
def test_random_plan_matches_jax(seed):
    """The JAX package and the port run the seeded plan over the same
    numpy data: the same schema and rows in order, every value bit for bit
    but float SUMs within their order bound, or the same exception.  FLOAT
    columns a SUM reads hold no NaN here (``torch_fuzz._f32_sum_nans``)."""
    case = F.random_case(seed, FUZZ_SIZES, f32_sum_nans=False)
    _, err = F.compare_results(case, F.run_case(J, case),
                               F.run_case(T, case, "cpu"))
    assert err is None, f"{case.family} {case.note}: {err}"


def test_random_plans_cover_every_family():
    """The cross-check's seeds run every plan family: dense and sort-path
    group-bys, MergeUnionAll and UnionAll among them."""
    assert {F.random_case(s, FUZZ_SIZES).family
            for s in range(FUZZ_SEEDS)} == {
        "filter", "sort", "group_dense", "group_sort", "scalar", "compute",
        "join", "merge_union", "union_all"}


def test_tile_row_counts_read_the_kernel_sources():
    """The card's row counts come from compaction.cu's and spread.cu's
    tiles (4096 = 256 threads x 16 rows, 2048 output rows a block)."""
    assert F.tile_row_counts(REPO) == [0, 1, 2047, 2048, 2049, 4095, 4096,
                                       4097, 8193]


def test_compare_results_catches_each_difference():
    """The comparison of phase (am) and of the cross-check above fails on
    a value, a NaN, a -0.0, a NULL, a row, a float SUM past its bound, a
    missing raise and another message, and passes a SUM within it."""
    case = F.random_case(3, (100,))  # a ScalarAggregate
    case.float_sums = {"s": (0, "d")}
    schema = [("i", "INT64", True), ("x", "DOUBLE", True),
              ("s", "DOUBLE", True)]
    base = ("rows", schema, [(1, 0.0, 10.0), (2, float("nan"), 20.0)])
    bound = F._sum_bound(case, "s")
    assert 0 < bound < 1e-6
    assert F.compare_results(case, base, base) == (2, None)
    for rows in ([(1, 0.0, 10.0)], [(1, -0.0, 10.0), base[2][1]],
                 [(1, 0.0, 10.0), (2, 1.0, 20.0)],
                 [(None, 0.0, 10.0), base[2][1]],
                 [(1, 0.0, 10.0 + 2 * bound), base[2][1]]):
        assert F.compare_results(case, base, ("rows", schema, rows))[1]
    near = ("rows", schema, [(1, 0.0, 10.0 + bound / 2), base[2][1]])
    assert F.compare_results(case, base, near) == (2, None)
    boom = ("raises", "EvaluationError", "evaluation failed: x")
    assert F.compare_results(case, boom, boom) == (0, None)
    assert F.compare_results(case, boom, base)[1]
    assert F.compare_results(case, boom, ("raises", "EvaluationError",
                                          "evaluation failed: y"))[1]


def test_fuzz_module_imports_no_jax():
    """chip_smoke.py imports tests/torch_fuzz.py on the card's machine,
    which has no JAX."""
    for node in ast.walk(ast.parse((REPO / "tests" / "torch_fuzz.py")
                                   .read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module])
            for m in mods:
                assert m.split(".")[0] in ("numpy", "re", "pathlib"), m
