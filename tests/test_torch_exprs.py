"""The port's expressions and Compute against the JAX package, both on the
CPU: the same numpy columns, made from a seed, go through the same plan
built from either package, and every value of a valid row and every NULL
must agree bit for bit (NaNs by isnan)."""
import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T

from torch_parity import computed_plan, tables

torch.set_num_threads(1)

I32_MIN, I64_MIN = -2**31, -2**63
COLS = (("a", "INT32", True), ("b", "INT64", False), ("x", "FLOAT", False),
        ("y", "DOUBLE", True), ("c", "INT32", False), ("d", "INT64", False),
        ("p", "BOOL", True), ("q", "BOOL", True))


def _data(n=600, seed=3):
    """Signed integers with INT_MIN and small values, divisors holding 0
    and -1, floats with +-0, NaN and inf; NULLs in a, y, p and q."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-50, 50, n).astype(np.int32)
    a[:4] = [I32_MIN, I32_MIN, -7, 7]
    b = rng.integers(-2**40, 2**40, n)
    b[:4] = [I64_MIN, I64_MIN, -7, 7]
    c = rng.integers(-4, 5, n).astype(np.int32)  # 0 and -1 among them
    c[:4] = [-1, 0, 2, -2]
    d = rng.integers(-4, 5, n)
    d[:4] = [-1, 0, 2, -2]
    x = (rng.standard_normal(n) * 4).astype(np.float32)
    x[4:10] = [0.0, -0.0, np.inf, -np.inf, np.nan, 3.0]
    y = rng.standard_normal(n) * 1e3
    y[4:10] = [-0.0, 0.0, 2.0, np.nan, np.inf, 0.0]
    return {"a": (a, rng.random(n) > 0.1), "b": b, "x": x,
            "y": (y, rng.random(n) > 0.1), "c": c, "d": d,
            "p": (rng.random(n) < 0.5, rng.random(n) > 0.3),
            "q": (rng.random(n) < 0.5, rng.random(n) > 0.3)}


@pytest.fixture(scope="module")
def both():
    return tables(J, T, COLS, _data())


def _compute(ns, t, make):
    return ns.execute(ns.Compute(make(ns), ns.ScanTable(t)))


def assert_same(got, want):
    """Same schema (names, types, nullability), NULLs and valid values,
    bit for bit; NaN as NaN."""
    assert [(a.name, a.type.value, a.nullable) for a in got.schema] == \
        [(a.name, a.type.value, a.nullable) for a in want.schema]
    n = int(want.num_rows)
    assert int(got.num_rows) == n
    for a in want.schema:
        gc, wc = got.columns[a.name], want.columns[a.name]
        gv = gc.values[:n].numpy()
        wv = np.asarray(wc.values)[:n]
        ok = (np.ones(n, bool) if wc.valid is None
              else np.asarray(wc.valid)[:n])
        gok = np.ones(n, bool) if gc.valid is None else gc.valid[:n].numpy()
        np.testing.assert_array_equal(gok, ok, err_msg=a.name)
        gv, wv = gv[ok], wv[ok]
        assert gv.dtype == wv.dtype, (a.name, gv.dtype, wv.dtype)
        if gv.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv),
                                          err_msg=a.name)
            keep = ~np.isnan(wv)
            ibits = np.int32 if gv.dtype == np.float32 else np.int64
            np.testing.assert_array_equal(gv[keep].view(ibits),
                                          wv[keep].view(ibits),
                                          err_msg=a.name)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=a.name)


# (left, right) column pairs: each type, mixed widths and promotion
PAIRS = [("a", "c"), ("b", "d"), ("a", "d"), ("b", "c"), ("x", "c"),
         ("y", "x"), ("x", "y"), ("y", "b")]
OPS = ["Plus", "Minus", "Multiply", "DivideNulling", "DivideQuiet",
       "CppDivideNulling", "ModulusNulling"]


@pytest.mark.parametrize("op", OPS)
def test_arithmetic_matches_jax(both, op):
    """Every operator over INT32, INT64, FLOAT and DOUBLE pairs: type
    promotion, NULLs, a zero divisor (NULL for Nulling; inf/NaN for
    Quiet), -1 divisors, truncation toward zero of negative quotients."""
    jt, tt = both
    pairs = PAIRS if op != "ModulusNulling" else PAIRS[:4]

    def make(ns):
        return [getattr(ns, op)(ns.col(l), ns.col(r)).as_(f"{l}{r}")
                for l, r in pairs]

    assert_same(_compute(T, tt, make), _compute(J, jt, make))


@pytest.mark.parametrize("dividend", ["a", "b"], ids=["INT32", "INT64"])
def test_int_min_by_minus_one_matches_jax(dividend):
    """INT_MIN / -1 and INT_MIN % -1 compute without a trap and give the
    JAX package's values: INT_MIN and 0."""
    n = 8
    lo = I32_MIN if dividend == "a" else I64_MIN
    typ = "INT32" if dividend == "a" else "INT64"
    cols = (("n", typ, False), ("m", typ, False))
    jt, tt = tables(J, T, cols, {
        "n": np.array([lo, lo, lo, -7, 7, -7, 0, lo + 1],
                      np.int32 if typ == "INT32" else np.int64),
        "m": np.array([-1, 1, 2, 2, -2, -2, -1, -1],
                      np.int32 if typ == "INT32" else np.int64)})

    def make(ns):
        return [ns.CppDivideSignaling(ns.col("n"), ns.col("m")).as_("q"),
                ns.ModulusSignaling(ns.col("n"), ns.col("m")).as_("r"),
                ns.CppDivideNulling(ns.col("n"), ns.col("m")).as_("qn"),
                ns.ModulusNulling(ns.col("n"), ns.col("m")).as_("rn")]

    got = _compute(T, tt, make)
    assert_same(got, _compute(J, jt, make))
    q = got.columns["q"].values.tolist()
    r = got.columns["r"].values.tolist()
    assert q[:6] == [lo, lo, lo // 2, -3, -3, 3] and q[6] == 0
    assert r[:6] == [0, 0, 0, -1, 1, -1]


@pytest.mark.parametrize("dtype", [np.int32, np.int64],
                         ids=["INT32", "INT64"])
def test_safe_integer_division_matches_jax_row_for_row(dtype):
    """The quotient under the division expressions, zero-divisor rows
    included (whose value the Nulling form hides): the JAX package's 0, or
    1 for a negative dividend; INT_MIN / -1 wraps; others truncate."""
    from supersonic_tpu.exprs.arithmetic import _IntSafeDiv as JDiv
    from supersonic_tpu_torch.exprs.arithmetic import _IntSafeDiv as TDiv
    lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
    a = np.array([lo, lo, hi, -7, 7, -7, 7, 0, -1, 5, -5, lo], dtype)
    b = np.array([-1, 0, 0, 0, 0, 2, -2, 0, 0, 3, 3, 1], dtype)
    jq, jzero = JDiv.div(a, b, True)
    tq, tzero = TDiv.div(torch.from_numpy(a), torch.from_numpy(b), True)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(tzero.numpy(), np.asarray(jzero))
    assert tq.tolist()[:9] == [lo, 1, 0, 1, 0, -3, -3, 0, 1]


@pytest.mark.parametrize("op,flag", [
    ("DivideSignaling", "division by zero"),
    ("CppDivideSignaling", "division by zero"),
    ("ModulusSignaling", "modulus by zero")])
def test_zero_divisor_signals_like_jax(both, op, flag):
    """A zero divisor on a live row fails the evaluation in both
    packages, with the same flag."""
    jt, tt = both

    def make(ns):
        return [getattr(ns, op)(ns.col("b"), ns.col("d")).as_("z")]

    with pytest.raises(J.EvaluationError, match=flag):
        _compute(J, jt, make)
    with pytest.raises(T.EvaluationError, match=flag):
        _compute(T, tt, make)


def test_zero_divisor_past_the_live_rows_does_not_signal():
    """The flag counts live rows only: a zero divisor in the padding does
    not fire."""
    cols = (("n", "INT64", False), ("m", "INT64", False))
    jt, tt = tables(J, T, cols, {"n": np.array([6, -6], np.int64),
                                 "m": np.array([4, 3], np.int64)},
                    capacity=5)

    def make(ns):
        return [(ns.col("n") / ns.col("m")).as_("q"),
                ns.CppDivide(ns.col("n"), ns.col("m")).as_("cq"),
                (ns.col("n") % ns.col("m")).as_("r")]

    got = _compute(T, tt, make)
    assert_same(got, _compute(J, jt, make))
    assert got.to_pylist() == [(1.5, 1, 2), (-2.0, -2, 0)]


def test_negate_matches_jax(both):
    jt, tt = both

    def make(ns):
        return [(-ns.col(c)).as_(f"n{c}") for c in "abxy"]

    assert_same(_compute(T, tt, make), _compute(J, jt, make))


@pytest.mark.parametrize("op", ["And", "Or", "Xor", "AndNot"])
def test_three_valued_logic_matches_jax(op):
    """Every pair of TRUE, FALSE and NULL, as the reference's
    three-valued logic (FALSE AND NULL = FALSE, TRUE OR NULL = TRUE)."""
    tv = [True, True, True, False, False, False, None, None, None]
    uv = [True, False, None] * 3
    cols = (("p", "BOOL", True), ("q", "BOOL", True))
    data = {"p": (np.array([bool(v) for v in tv]),
                  np.array([v is not None for v in tv])),
            "q": (np.array([bool(v) for v in uv]),
                  np.array([v is not None for v in uv]))}
    jt, tt = tables(J, T, cols, data)

    def make(ns):
        return [getattr(ns, op)(ns.col("p"), ns.col("q")).as_("r"),
                ns.Not(ns.col("p")).as_("np")]

    got = _compute(T, tt, make)
    assert_same(got, _compute(J, jt, make))
    want = {"And": [True, False, None, False, False, False, None, False,
                    None],
            "Or": [True, True, True, True, False, None, True, None, None],
            "Xor": [False, True, None, True, False, None, None, None, None],
            "AndNot": [False, False, False, True, False, None, None, False,
                       None]}[op]
    assert [r[0] for r in got.to_pylist()] == want


def test_logic_over_the_seeded_columns_matches_jax(both):
    jt, tt = both

    def make(ns):
        p, q = ns.col("p"), ns.col("q")
        return [(p & q).as_("and"), (p | q).as_("or"), (~p).as_("not"),
                ns.Xor(p, q).as_("xor"), ns.AndNot(p, q).as_("andnot")]

    assert_same(_compute(T, tt, make), _compute(J, jt, make))


@pytest.mark.parametrize("op", ["BitwiseAnd", "BitwiseOr", "BitwiseXor",
                                "BitwiseAndNot", "ShiftLeft", "ShiftRight",
                                "BitwiseNot"])
def test_bitwise_matches_jax(both, op):
    jt, tt = both

    def make(ns):
        if op == "BitwiseNot":
            return [ns.BitwiseNot(ns.col(c)).as_(c) for c in "abcd"]
        if op.startswith("Shift"):
            # shift counts inside the width: 0..4
            amount = ns.BitwiseAnd(ns.col("d"), ns.ConstInt64(3))
            return [getattr(ns, op)(ns.col(c), amount).as_(c) for c in "ab"]
        return [getattr(ns, op)(ns.col(l), ns.col(r)).as_(f"{l}{r}")
                for l, r in (("a", "c"), ("b", "d"), ("a", "d"))]

    assert_same(_compute(T, tt, make), _compute(J, jt, make))


def test_is_null_and_if_null_match_jax(both):
    """IsNull of nullable and non-nullable columns; IfNull over numeric
    promotion, with a non-nullable fallback (a non-nullable result) and a
    nullable one."""
    jt, tt = both

    def make(ns):
        col = ns.col
        return [ns.IsNull(col("a")).as_("na"), ns.IsNull(col("b")).as_("nb"),
                ns.IfNull(col("a"), col("c")).as_("ac"),
                ns.IfNull(col("y"), col("x")).as_("yx"),
                ns.IfNull(col("a"), col("y")).as_("ay"),
                ns.IfNull(col("p"), col("q")).as_("pq"),
                ns.IfNull(col("a"), ns.Null(ns.DataType.INT64)).as_("an")]

    got = _compute(T, tt, make)
    assert_same(got, _compute(J, jt, make))
    nullable = {a.name: a.nullable for a in got.schema}
    assert nullable == {"na": False, "nb": False, "ac": False, "yx": False,
                        "ay": True, "pq": True, "an": True}


def test_if_null_over_strings_merges_dictionaries():
    """IfNull of two STRING columns with their own dictionaries: the
    result's codes index the merged dictionary."""
    cols = (("s", "STRING", True), ("t", "STRING", False))
    s_vals, t_vals = ("kiwi", "lime", "pear"), ("apple", "lime", "zucchini")
    codes_s = np.array([0, 2, 1, 0, 2], np.int32)
    valid_s = np.array([True, False, True, False, True])
    codes_t = np.array([2, 0, 1, 1, 0], np.int32)
    jt, tt = tables(J, T, cols, {"s": (codes_s, valid_s), "t": codes_t},
                    {"s": s_vals, "t": t_vals})

    def make(ns):
        return [ns.IfNull(ns.col("s"), ns.col("t")).as_("r")]

    got, want = _compute(T, tt, make), _compute(J, jt, make)
    assert got.to_pylist() == want.to_pylist() == [
        ("kiwi",), ("apple",), ("lime",), ("lime",), ("pear",)]
    assert got.dicts["r"].values == want.dicts["r"].values


def test_sequence_and_null_over_a_capacity_past_the_rows():
    """Sequence counts over the whole capacity (int64), past num_rows, as
    the JAX package's does; Null is an all-NULL typed column."""
    cols = (("a", "INT32", False),)
    jt, tt = tables(J, T, cols, {"a": np.arange(5, dtype=np.int32)},
                    capacity=12)

    def make(ns):
        return [ns.Sequence().as_("seq"), ns.col("a"),
                ns.Null(ns.DataType.DOUBLE).as_("nul")]

    got, want = _compute(T, tt, make), _compute(J, jt, make)
    assert_same(got, want)
    assert got.columns["seq"].values.dtype == torch.int64
    assert got.columns["seq"].values.tolist() == list(range(12))
    assert np.asarray(want.columns["seq"].values).tolist() == list(range(12))
    assert got.to_pylist() == [(i, i, None) for i in range(5)]


def test_filter_on_a_compound_predicate_matches_jax(both):
    """Filter((a > x) & ~(b < y)): three-valued AND and NOT over
    comparisons with NULLs, through the compaction."""
    jt, tt = both

    def plan(ns, t):
        c = ns.col
        return ns.Filter((c("a") > c("x")) & ~(c("b") < c("y")),
                         ns.ScanTable(t))

    got, want = T.execute(plan(T, tt)), J.execute(plan(J, jt))
    assert int(got.num_rows) > 0
    assert_same(got, want)


def test_computed_plan_matches_jax(both):
    """Compute with arithmetic, IfNull, IsNull and Sequence, then a Filter
    on a logic predicate over its outputs (torch_parity.computed_plan)."""
    jt, tt = both
    got = T.execute(computed_plan(T, tt))
    want = J.execute(computed_plan(J, jt))
    assert int(got.num_rows) > 0
    assert_same(got, want)


def test_operator_sugar_builds_the_jax_operators():
    """+ - * / % neg & | ~ build the same operators as the JAX package's
    sugar."""
    def build(ns):
        a, b = ns.col("a"), ns.col("b")
        return [a + b, 1 + a, a - b, 2 - a, a * b, 3 * a, a / b, a % b, -a,
                a & b, a | b, ~a]

    got = [type(e).__name__ for e in build(T)]
    assert got == [type(e).__name__ for e in build(J)]
    assert got == ["Plus", "Plus", "Minus", "Minus", "Multiply", "Multiply",
                   "DivideSignaling", "ModulusSignaling", "Negate", "And",
                   "Or", "Not"]


def test_compute_forwards_no_statistics():
    """Like the JAX package's, a Compute's output has no planner
    statistics, so a group-by over it takes the sort path."""
    cols = (("k", "INT32", False),)
    _, tt = tables(J, T, cols, {"k": np.array([3, 1, 3], np.int32)})
    leaf = T.ScanTable(tt)
    assert T.ops.base.BindContext and leaf.bind(T.BindContext()).stats
    bound = T.Compute([T.col("k")], leaf).bind(T.BindContext())
    assert bound.stats == {} and bound.rowid == set()
