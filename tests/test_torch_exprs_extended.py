"""The port's expression engine beyond the conformance block: time zones,
the segmented scans and the stateful expressions across tiles, the
deferred rendering, the signaling failures, the float -> integer casts,
and the UINT32/UINT64 columns through the operators, each against the JAX
package on the same seeded inputs (exact; transcendental functions
within rtol 1e-12)."""
from __future__ import annotations

import datetime
import zoneinfo

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu.exprs import tz as jtz
from supersonic_tpu.ops import segscan as JS
from supersonic_tpu_torch.exprs import tz as ttz
from supersonic_tpu_torch.ops import segscan as TS
from supersonic_tpu_torch import types as TT
from torch_parity import bit_rows, same_rows, schema, tables

torch.set_num_threads(1)


def _pair(cols, data):
    """(JAX table, port table on the CPU) over the same data: value arrays
    or lists, or (values, valid) pairs for NULLs."""
    if any(isinstance(v, tuple) for v in data.values()):
        return tables(J, T, cols, data)
    return (J.Table.from_data(schema(J, cols), data),
            T.Table.from_data(schema(T, cols), data, device="cpu"))


def _compute(make, pair):
    """Compute(make(ns)) in both packages: the same rows (floats bit for
    bit)."""
    return same_rows(J, T, lambda ns, t: ns.Compute(make(ns),
                                                    ns.ScanTable(t)), pair)


@pytest.fixture
def zone():
    """Set a local timezone in both packages; the default after."""
    def setter(name):
        J.set_local_timezone(name)
        T.set_local_timezone(name)
    yield setter
    J.set_local_timezone(None)
    T.set_local_timezone(None)


NY_PROBES = [0, -1, -2_000_000_000, 1710050399, 1710050400, 1710053999,
             1710054000, 1730613599, 1730613600, 2145916800]


@pytest.mark.parametrize("name,probes", [
    ("America/New_York", NY_PROBES),
    ("Asia/Kathmandu", [0, 504901800 - 1, 504901800, 1700000000]),
    ("Australia/Lord_Howe", [1712417400 - 1, 1712417400, 1759595400 - 1,
                             1759595400]),
])
def test_local_fields_match_jax_and_zoneinfo(zone, name, probes):
    zone(name)
    secs = list(probes) + list(np.random.default_rng(7).integers(
        -10**9, 2**31, 48))
    pair = _pair((("t", "DATETIME", False),),
                 {"t": np.array(secs, dtype=np.int64) * 1_000_000})
    rows = _compute(lambda P: [
        P.YearLocal(P.col("t")).as_("y"), P.MonthLocal(P.col("t")).as_("mo"),
        P.DayLocal(P.col("t")).as_("d"), P.HourLocal(P.col("t")).as_("h"),
        P.MinuteLocal(P.col("t")).as_("mi"),
        P.SecondLocal(P.col("t")).as_("s"),
        P.WeekdayLocal(P.col("t")).as_("wd"),
        P.YearDayLocal(P.col("t")).as_("yd"),
        P.QuarterLocal(P.col("t")).as_("q"),
        P.DateFormatLocal(P.col("t"), "%Y-%m-%d %H:%M:%S").as_("f")], pair)
    z = zoneinfo.ZoneInfo(name)
    for sec, r in zip(secs, rows):
        loc = datetime.datetime.fromtimestamp(int(sec), z)
        assert r[:6] == (loc.year, loc.month, loc.day, loc.hour, loc.minute,
                         loc.second), sec
        assert r[9] == loc.strftime("%Y-%m-%d %H:%M:%S"), sec


def test_tz_tables_and_host_shift_match_jax(zone):
    zone("Australia/Lord_Howe")
    a, b = jtz.current_tables(), ttz.current_tables()
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    secs = np.random.default_rng(3).integers(-10**9, 2**31, 64)
    us = torch.from_numpy(secs * 1_000_000)
    dev = ttz.local_shift(us, b).tolist()
    assert dev == [ttz.local_shift_host(int(u), b) for u in us] == \
        [jtz.local_shift_host(int(u), a) for u in us]
    assert ttz.get_local_timezone() == "Australia/Lord_Howe"


def test_unknown_zone_raises_not_utc():
    """A zone that cannot be loaded raises; it is never bound as UTC."""
    with pytest.raises(Exception):
        T.set_local_timezone("Nowhere/Atlantis")
    assert T.get_local_timezone() == "UTC"


@pytest.mark.parametrize("n", [1, 7, 257, 2049, 5000])
def test_segmented_scans_match_jax(n):
    """Around the port's 256-row and the JAX package's 2048-row tiles."""
    import jax

    rng = np.random.default_rng(n)
    r = rng.random(n) < 0.01
    for v in (rng.random(n), rng.integers(-10**12, 10**12, n)):
        jv, jr = jax.numpy.asarray(v), jax.numpy.asarray(r)
        tv, tr = torch.from_numpy(v), torch.from_numpy(r)
        for name in ("seg_cummin", "seg_cummax", "seg_carry_first"):
            got = getattr(TS, name)(tv, tr).numpy()
            want = np.asarray(jax.jit(getattr(JS, name))(jv, jr))
            np.testing.assert_array_equal(got, want, err_msg=name)
        got = TS.seg_cumsum(tv, tr).numpy()
        want = np.asarray(jax.jit(JS.seg_cumsum)(jv, jr))
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-12)
        else:
            np.testing.assert_array_equal(got, want)


def test_stateful_across_tiles_match_jax():
    """Every stateful expression over 5000 rows (many scan tiles), NULLs
    and flushes scattered; RunningSum of INT32 wraps."""
    rng = np.random.default_rng(5)
    n = 5000
    v = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    pair = _pair((("v", "INT32", True), ("d", "DOUBLE", True),
                  ("f", "BOOL", False), ("s", "INT64", False)),
                 {"v": (v, rng.random(n) < 0.7),
                  "d": (rng.random(n), rng.random(n) < 0.5),
                  "f": rng.random(n) < 0.01,
                  "s": rng.integers(0, 3, n)})
    rows = _compute(lambda P: [
        P.RunningSum(P.col("v")).as_("rs"), P.Smudge(P.col("v")).as_("sm"),
        P.SmudgeIf(P.col("d"), P.col("f")).as_("si"),
        P.RunningMinWithFlush(P.col("f"), P.col("v")).as_("rm"),
        P.RunningMinWithFlush(P.col("f"), P.col("d")).as_("rmd"),
        P.Changed(P.col("s")).as_("ch")], pair)
    assert rows[0][0] is not None or rows[0][1] is None


def test_deferred_rendering_matches_jax():
    """ToString of FLOAT, DOUBLE, INT64 and UINT64, Format and DateFormat
    without a domain (the per-row rendering after the run), also after a
    Filter and a Sort have moved the rows."""
    rng = np.random.default_rng(1)
    n = 200
    f = np.concatenate([rng.random(n - 5, dtype=np.float32) * 100,
                        np.float32([0.1, 2.0, 1e-7, -0.0, 1e30])])
    pair = _pair((("k", "INT32", False), ("f", "FLOAT", False),
                  ("d", "DOUBLE", True), ("v", "INT64", False),
                  ("u", "UINT64", False), ("t", "DATETIME", False)),
                 {"k": rng.integers(0, 50, n).astype(np.int32), "f": f,
                  "d": (rng.random(n) * 1e6 - 5e5, rng.random(n) < 0.9),
                  "v": rng.integers(-10**12, 10**12, n),
                  "u": rng.integers(0, 2**63, n).astype(np.uint64) * 2 + 1,
                  "t": rng.integers(-2**40, 2**51, n)})

    def plan(ns, t):
        c = ns.col
        comp = ns.Compute([c("k"), ns.ToString(c("f")).as_("sf"),
                           ns.ToString(c("d")).as_("sd"),
                           ns.ToString(c("v")).as_("sv"),
                           ns.ToString(c("u")).as_("su"),
                           ns.Format(c("d"), 3).as_("fd"),
                           ns.DateFormat(c("t"), "%Y-%m-%d %H:%M:%S %j")
                           .as_("ft")], ns.ScanTable(t))
        return ns.Sort([("k", True)], ns.Filter(
            c("k") > ns.Const(10, ns.DataType.INT32), comp))
    got = T.execute(plan(T, pair[1])).to_pylist()
    want = J.execute(plan(J, pair[0])).to_pylist()
    assert sorted(got) == sorted(want) and len(got) > 100


def test_deferred_column_is_not_a_key():
    t = T.Table.from_data(T.TupleSchema.of(("d", T.DOUBLE, False)),
                          {"d": [1.0, 2.0]}, device="cpu")
    with pytest.raises(T.SchemaError, match="cannot be used as a sort"):
        T.execute(T.Sort(["s"], T.Compute([T.ToString(T.col("d")).as_("s")],
                                          T.ScanTable(t))))


@pytest.mark.parametrize("case", [
    "divide", "modulus", "cast", "parse", "makedate", "tostring_domain",
    "dateformat_domain", "ln", "pow"])
def test_signaling_failures_raise_in_both(case):
    """Each signaling failure raises EvaluationError in both packages, with
    the same flag name."""
    pair = _pair((("x", "DOUBLE", False), ("i", "INT32", False),
                  ("s", "STRING", False)),
                 {"x": [1.5, -2.0, 3e10], "i": [0, 3, -1],
                  "s": ["7", "x", "9"]})
    make = {
        "divide": lambda P: P.DivideSignaling(P.col("x"), P.col("i")),
        "modulus": lambda P: P.ModulusSignaling(P.col("i"), P.col("i")),
        "cast": lambda P: P.CastSignaling(P.DataType.INT32, P.col("x")),
        "parse": lambda P: P.ParseStringQuiet(P.DataType.INT32, P.col("s")),
        "makedate": lambda P: P.MakeDate(P.Const(1960), P.col("i"),
                                         P.Const(1)),
        "tostring_domain": lambda P: P.ToString(P.col("i"), domain=(0, 2)),
        "dateformat_domain": lambda P: P.DateFormat(
            P.FromUnixTime(P.col("i")), "%Y", domain=(0, 10)),
        "ln": lambda P: P.LnSignaling(P.col("x")),
        "pow": lambda P: P.PowSignaling(P.col("x"), P.Const(0.5)),
    }[case]
    msgs = []
    for ns, t in ((J, pair[0]), (T, pair[1])):
        plan = ns.Compute([make(ns).as_("o")], ns.ScanTable(t))
        if case == "parse":  # quiet: no flag, garbage stays valid
            msgs.append(ns.execute(plan).to_pylist())
            continue
        with pytest.raises(ns.EvaluationError) as e:
            ns.execute(plan)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


X = [float("nan"), float("inf"), -float("inf"), 2.0**40, -2.0**40, 3.7,
     -3.7, 2.0**63, 2.0**64, -1.0, 2.0**31, -2.0**31 - 1.0, 2.0**32]


@pytest.mark.parametrize("dst", ["INT32", "INT64", "UINT32", "UINT64",
                                 "DATE", "DATETIME"])
def test_float_to_integer_casts_match_jax(dst):
    """NaN to 0, +-inf and +-2^40 saturate, truncation toward zero: XLA's
    convert, by explicit clamps and selects (torch's own ``.to`` of these
    differs between the CPU and CUDA)."""
    for src in ("DOUBLE", "FLOAT"):
        pair = _pair((("x", src, False),), {"x": np.array(X)})
        _compute(lambda P: [P.CastTo(getattr(P.DataType, dst), P.col("x"))
                            .as_("o")], pair)


U = np.array([0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1025,
              2**64 - 1, 12345678901234567], dtype=np.uint64)


def test_uint64_word_operations_match_numpy():
    """Unsigned compare, divide, modulus, right shift and the cast to a
    float, on int64 bit patterns, against numpy's uint64."""
    a = torch.from_numpy(U.view(np.int64))
    for b_np in (U[::-1].copy(), np.full(len(U), 7, np.uint64),
                 np.full(len(U), 2**63 + 3, np.uint64)):
        b_np = np.where(b_np == 0, np.uint64(3), b_np)
        b = torch.from_numpy(b_np.view(np.int64))
        q, r = TT.u64_divmod(a, b)
        assert (q.numpy().view(np.uint64) == U // b_np).all()
        assert (r.numpy().view(np.uint64) == U % b_np).all()
        assert ((TT.u64_key(a) < TT.u64_key(b)).numpy() == (U < b_np)).all()
    for s in (0, 1, 31, 32, 63):
        assert (TT.u64_shr(a, s).numpy().view(np.uint64)
                == U >> np.uint64(s)).all()
    assert TT.convert(a, T.UINT64, T.DOUBLE).tolist() == \
        U.astype(np.float64).tolist()
    assert TT.convert(a, T.UINT64, T.FLOAT).tolist() == \
        U.astype(np.float32).tolist()


def test_unsigned_columns_through_the_operators():
    """UINT32 and UINT64 columns as group keys (UINT32 dense by its
    statistics), SUM (wrapping), MIN, MAX and COUNT inputs, sort keys, merge
    keys and join keys: the JAX package's rows."""
    rng = np.random.default_rng(11)
    n = 300
    u64 = np.concatenate([U, rng.integers(0, 2**63, n - len(U))
                          .astype(np.uint64) * 2 + 1])
    cols = (("k", "UINT32", False), ("u", "UINT64", True),
            ("w", "UINT32", False), ("x", "INT32", False))
    data = {"k": rng.integers(2**32 - 40, 2**32, n).astype(np.uint32),
            "u": (u64, rng.random(n) < 0.9),
            "w": rng.integers(2**31, 2**32, n).astype(np.uint32),
            "x": np.arange(n, dtype=np.int32)}
    pair = _pair(cols, data)
    A = "Aggregation"

    def group(ns, t):
        ag = getattr(ns, A)
        return ns.Sort(["k"], ns.GroupAggregate(["k"], [
            ns.AggSpec(ag.SUM, "u", "su"), ns.AggSpec(ag.MIN, "u", "mn"),
            ns.AggSpec(ag.MAX, "u", "mx"), ns.AggSpec(ag.SUM, "w", "sw"),
            ns.AggSpec(ag.COUNT, "u", "c")], ns.ScanTable(t)))
    same_rows(J, T, group, pair)

    def scalar(ns, t):
        ag = getattr(ns, A)
        return ns.ScalarAggregate([
            ns.AggSpec(ag.SUM, "u", "su"), ns.AggSpec(ag.MIN, "u", "mn"),
            ns.AggSpec(ag.MAX, "u", "mx"), ns.AggSpec(ag.SUM, "w", "sw")],
            ns.ScanTable(t))
    same_rows(J, T, scalar, pair)
    for asc in (True, False):
        same_rows(J, T, lambda ns, t: ns.Sort(
            [ns.SortKey("u", ascending=asc), ns.SortKey("x")],
            ns.ScanTable(t)), pair)
    half = [_pair(cols, {k: (v[0][i::2], v[1][i::2]) if isinstance(v, tuple)
                         else v[i::2] for k, v in data.items()})
            for i in (0, 1)]

    def merge(ns, a, b):
        keys = [ns.SortKey("u", ascending=False), ns.SortKey("x")]
        return ns.MergeUnionAll(keys, [ns.Sort(keys, ns.ScanTable(a)),
                                       ns.Sort(keys, ns.ScanTable(b))])
    same_rows(J, T, merge, *half)

    def join(ns, a, b):
        return ns.HashJoin(ns.JoinType.INNER, ["k"], ["k"], ns.ScanTable(a),
                           ns.ScanTable(b), ns.KeyUniqueness.NOT_UNIQUE,
                           lhs_projector=ns.Projector.named("x", "u"),
                           rhs_projector=ns.Projector([("x", "x2")]),
                           out_capacity=4000)
    got = T.execute(join(T, half[0][1], half[1][1])).to_pylist()
    want = J.execute(join(J, half[0][0], half[1][0])).to_pylist()
    assert sorted(bit_rows(got)) == sorted(bit_rows(want)) and got

    def join64(ns, a, b):
        return ns.HashJoin(ns.JoinType.LEFT_OUTER, ["u"], ["u"],
                           ns.ScanTable(a), ns.ScanTable(b),
                           ns.KeyUniqueness.UNIQUE,
                           rhs_projector=ns.Projector([("x", "x2")]))
    same_rows(J, T, join64, pair, pair)


def test_take_small_and_bound_luts_on_the_cpu():
    """take_small clips its indices as the JAX package's does; a bound LUT
    is uploaded once per device and reused."""
    from supersonic_tpu_torch.kernels.lut_gather import BoundLut, take_small

    lut = BoundLut(np.array([5, 6, 7], dtype=np.int32))
    idx = torch.tensor([-3, 0, 2, 9], dtype=torch.int64)
    assert take_small(lut, idx).tolist() == [5, 5, 7, 7]
    first = lut.on("cpu")
    take_small(lut, idx.to(torch.int32))
    assert lut.on("cpu") is first


def test_float_rendering_matches_the_jax_printers():
    """The port prints floats an array at a time, in numpy: the same
    strings as the JAX package's per-value SimpleFtoa/SimpleDtoa printers
    (``supersonic_tpu.ops.host._fmt_float``/``_fmt_double``), edge values
    included."""
    from supersonic_tpu.ops.host import _fmt_double, _fmt_float
    from supersonic_tpu_torch.ops.host import _fmt_doubles, _fmt_floats

    rng = np.random.default_rng(9)
    edges = [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-45,
             1.1754943508222875e-38, 3.4028234663852886e38, 0.1, 1e7, 1e-7,
             16777217.0, 123456789.0]
    with np.errstate(over="ignore"):
        scaled = (rng.standard_normal(20000)
                  * 10.0 ** rng.integers(-40, 38, 20000)).astype(np.float32)
    f = np.concatenate([np.float32(edges), scaled,
                        rng.integers(-2**31, 2**31, 5000).astype(np.int32)
                        .view(np.float32)])
    assert _fmt_floats(f) == [_fmt_float(x) for x in f]
    d = np.concatenate([np.float64(edges), rng.standard_normal(20000)
                        * 10.0 ** rng.integers(-300, 300, 20000),
                        rng.integers(-2**63, 2**63, 5000).view(np.float64)])
    assert _fmt_doubles(d) == [_fmt_double(x) for x in d]


def test_constant_subtrees_fold_without_changing_flags():
    """A subtree of constants evaluates once on one row and broadcasts (the
    JAX package's compiled programs fold it): the same rows as the JAX
    package, and a failure it raises still needs a live row."""
    pair = _pair((("d", "DATE", False), ("i", "INT32", False)),
                 {"d": [9374, 9400, 9404, 9500], "i": [1, 2, 3, 4]})
    rows = _compute(lambda P: [
        (P.col("d") < P.AddMonths(P.ConstDate(9374), 1)).as_("lt"),
        P.Plus(P.Multiply(P.Const(3), P.Const(4)), P.col("i")).as_("p"),
        P.Year(P.MakeDate(P.Const(2001), P.Const(14), P.Const(1))).as_("y"),
        P.CastTo(P.DataType.DOUBLE, P.Negate(P.Const(7))).as_("c")], pair)
    assert [r[0] for r in rows] == [True, True, False, False]
    assert rows[0][1:] == (13, 2002, -7.0)
    empty = _pair((("i", "INT32", False),),
                  {"i": np.zeros(0, np.int32)})
    bad = (lambda P: [P.MakeDate(P.Const(1960), P.Const(1), P.Const(1))
                      .as_("m")])
    assert _compute(bad, empty) == []
    one = _pair((("i", "INT32", False),), {"i": [5]})
    for ns, t in ((J, one[0]), (T, one[1])):
        with pytest.raises(ns.EvaluationError, match="MAKEDATE"):
            ns.execute(ns.Compute(bad(ns), ns.ScanTable(t)))
