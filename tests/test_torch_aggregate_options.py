"""The rest of the port's aggregation against the JAX package, both on the
CPU, mirroring tests/test_aggregate.py and tests/test_quota.py:
ScalarAggregate, AggregateClusters, DISTINCT, ``max_unique_keys_in_result``,
strict, best-effort and enforced memory quotas, a group-by without keys,
CONCAT and HybridGroupAggregate.  The same numpy columns, made from a seed,
go through the same plan built from either package.  Every value must be
equal, but DOUBLE DISTINCT sums, within 1e-12 of max(1, the group's sum of
|x|) (the JAX package adds them in fixed point, the port in f64).  Keys
are nullable or 64-bit, so the JAX package takes its sort path, not its
interpret-mode kernel."""
import math
import warnings

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu.ops.aggregate as JA
import supersonic_tpu_torch as T
import supersonic_tpu_torch.ops.aggregate as TA
from supersonic_tpu_torch.ops import host as T_host

from torch_parity import bit_rows, same_rows, schema, tables

torch.set_num_threads(1)

WARNING = "best-effort group-by exceeded memory_quota"


def _spec(ns, agg, inp, out, **kw):
    return ns.AggSpec(getattr(ns.Aggregation, agg), inp, out, **kw)


def _data(n=160, seed=3):
    """k: nullable INT64 key; v: nullable INT64; f: nullable DOUBLE with
    -0.0, +0.0 and NaNs; s: nullable STRING; x: FLOAT."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-3, 4, n).astype(np.float64)
    f[rng.random(n) < 0.15] = -0.0
    f[rng.random(n) < 0.1] = np.nan
    cols = (("k", "INT64", True), ("v", "INT64", True), ("f", "DOUBLE", True),
            ("s", "STRING", True), ("x", "FLOAT", False))
    data = {"k": (rng.integers(0, 12, n), rng.random(n) > 0.1),
            "v": (rng.integers(-5, 6, n), rng.random(n) > 0.2),
            "f": (f, rng.random(n) > 0.1),
            "s": (rng.integers(0, 4, n).astype(np.int32),
                  rng.random(n) > 0.2),
            "x": rng.random(n).astype(np.float32)}
    return tables(J, T, cols, data, {"s": ("a", "bb", "c", "dd")})


DATA = _data()


def _execute(ns, plan):
    """Rows and the warnings raised while executing ``plan``."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        rows = ns.execute(plan).to_pylist()
    return rows, sorted({str(w.message) for w in seen})


def _both(make, pair=DATA):
    """(port rows, JAX rows) of make(ns, table); the warnings must agree."""
    got, gw = _execute(T, make(T, pair[1]))
    want, ww = _execute(J, make(J, pair[0]))
    assert gw == ww
    return got, want


def _close_rows(got, want, float_cols, rtol=1e-12):
    """Equal rows, the float columns of ``float_cols`` (positions) within
    rtol of max(1, |JAX value|); NaN equals NaN."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            if i in float_cols and a is not None and b is not None:
                assert (math.isnan(a) and math.isnan(b)) or \
                    abs(a - b) <= rtol * max(1.0, abs(b)), (g, w)
            else:
                assert bit_rows([(a,)]) == bit_rows([(b,)]), (g, w)


# ---- ScalarAggregate -------------------------------------------------------

def _scalar_all(ns, t):
    return ns.ScalarAggregate(
        [_spec(ns, "SUM", "v", "sv"), _spec(ns, "COUNT", None, "c"),
         _spec(ns, "COUNT", "f", "cf"), _spec(ns, "MIN", "f", "mn"),
         _spec(ns, "MAX", "v", "mx"), _spec(ns, "FIRST", "s", "fs"),
         _spec(ns, "LAST", "v", "lv"), _spec(ns, "MIN", "s", "ms"),
         _spec(ns, "SUM", "x", "sx", output_type=ns.DataType.DOUBLE)],
        ns.ScanTable(t))


@pytest.mark.parametrize("case", ["all_rows", "filtered", "keep_nothing",
                                  "empty_input"])
def test_scalar_aggregate_matches_jax(case):
    """Exactly one row, even over nothing: SUM/MIN/MAX NULL without a
    valid row, COUNT(*) and COUNT(col) never NULL, FIRST/LAST rows 0 and
    n - 1."""
    pair = DATA
    if case == "empty_input":
        cols = (("k", "INT64", True), ("v", "INT64", True),
                ("f", "DOUBLE", True), ("s", "STRING", True),
                ("x", "FLOAT", False))
        z = np.zeros(0, bool)
        pair = tables(J, T, cols, {
            "k": (np.zeros(0, np.int64), z), "v": (np.zeros(0, np.int64), z),
            "f": (np.zeros(0), z), "s": (np.zeros(0, np.int32), z),
            "x": np.zeros(0, np.float32)}, {"s": ("a",)})

    def make(ns, t):
        plan = _scalar_all(ns, t)
        if case in ("filtered", "keep_nothing"):
            c = 3 if case == "filtered" else 99
            plan.child = ns.Filter(
                ns.col("v") > ns.Const(c, ns.DataType.INT64), plan.child)
        return plan

    got, want = _both(make, pair)
    _close_rows(got, want, {8}, rtol=1e-6)
    assert len(got) == 1
    if case in ("keep_nothing", "empty_input"):
        assert got == [(None, 0, 0, None, None, None, None, None, None)]


def test_scalar_distinct_matches_jax():
    """DISTINCT SUM/COUNT over INT64, DOUBLE (-0.0 and +0.0 are one value,
    each NaN a value of its own) and STRING codes, NULLs never counted."""
    def make(ns, t):
        return ns.ScalarAggregate(
            [_spec(ns, "COUNT", "v", "cv", distinct=True),
             _spec(ns, "SUM", "v", "sv", distinct=True),
             _spec(ns, "COUNT", "f", "cf", distinct=True),
             _spec(ns, "SUM", "f", "sf", distinct=True),
             _spec(ns, "COUNT", "s", "cs", distinct=True)],
            ns.ScanTable(t))

    got, want = _both(make)
    _close_rows(got, want, {3})
    f, ok = (DATA[1].columns["f"].values.numpy(),
             DATA[1].columns["f"].valid.numpy())
    live = f[ok]
    assert got[0][2] == len(set(live[~np.isnan(live)].tolist())) + int(
        np.isnan(live).sum())


def test_scalar_aggregate_and_keyless_group_by_differ_on_empty_input():
    """ScalarAggregate gives one row on empty input; GroupAggregate without
    keys gives one row over live rows and none over nothing, as the JAX
    package does."""
    cols = (("v", "INT64", False),)
    full = tables(J, T, cols, {"v": np.array([1, 2, 3])})
    empty = tables(J, T, cols, {"v": np.zeros(0, np.int64)})
    for ns_rows, pair, scalar in (([(6,)], full, True), ([(6,)], full, False),
                                  ([(None,)], empty, True), ([], empty, False)):
        def make(ns, t, scalar=scalar):
            specs = [_spec(ns, "SUM", "v", "s")]
            if scalar:
                return ns.ScalarAggregate(specs, ns.ScanTable(t))
            return ns.GroupAggregate([], specs, ns.ScanTable(t))
        assert same_rows(J, T, make, pair) == ns_rows


@pytest.mark.parametrize("filtered", [False, True])
def test_keyless_group_by_matches_jax(filtered):
    """Every aggregation of a group-by without keys, over a fused Filter
    too: one group over the live rows."""
    def make(ns, t):
        child = ns.ScanTable(t)
        if filtered:
            child = ns.Filter(ns.col("x") > ns.Const(0.5, ns.DataType.FLOAT),
                              child)
        return ns.GroupAggregate(
            [], [_spec(ns, "SUM", "v", "sv"), _spec(ns, "COUNT", None, "c"),
                 _spec(ns, "MIN", "f", "mn"), _spec(ns, "MAX", "s", "mx"),
                 _spec(ns, "FIRST", "s", "fs"), _spec(ns, "LAST", "v", "lv"),
                 _spec(ns, "COUNT", "v", "dv", distinct=True)], child)

    rows = same_rows(J, T, make, DATA)
    assert len(rows) == 1


# ---- AggregateClusters -----------------------------------------------------

def test_aggregate_clusters_keeps_non_adjacent_keys_apart():
    cols = (("k", "INT64", False), ("v", "INT64", False))
    pair = tables(J, T, cols, {"k": np.array([1, 1, 3, 3, 2]),
                               "v": np.array([1, 2, 3, 4, 5])})
    rows = same_rows(J, T, lambda ns, t: ns.AggregateClusters(
        ["k"], [_spec(ns, "SUM", "v", "s")], ns.ScanTable(t)), pair)
    assert rows == [(1, 3), (3, 7), (2, 5)]


@pytest.mark.parametrize("key", ["s", "k"])
def test_aggregate_clusters_match_jax(key):
    """Runs of adjacent equal keys in input order over random (barely
    clustered) input, every aggregation including DISTINCT, through
    AggregateClusters and its output-block-size form."""
    def make(ns, t):
        specs = [_spec(ns, "SUM", "v", "sv"), _spec(ns, "COUNT", None, "c"),
                 _spec(ns, "MIN", "f", "mn"), _spec(ns, "MAX", "v", "mx"),
                 _spec(ns, "FIRST", "x", "fx"), _spec(ns, "LAST", "s", "ls"),
                 _spec(ns, "COUNT", "v", "dc", distinct=True)]
        if key == "k":
            return ns.AggregateClustersWithSpecifiedOutputBlockSize(
                [key], specs, 160, ns.ScanTable(t))
        return ns.AggregateClusters([key], specs, ns.ScanTable(t))

    rows = same_rows(J, T, make, DATA)
    assert len(rows) > 100


def test_aggregate_clusters_under_a_filter_matches_jax():
    """A Filter child compacts, so its dead rows are a suffix."""
    same_rows(J, T, lambda ns, t: ns.AggregateClusters(
        ["k"], [_spec(ns, "SUM", "v", "sv"), _spec(ns, "MIN", "v", "mn")],
        ns.Filter(ns.col("x") > ns.Const(0.3, ns.DataType.FLOAT),
                  ns.ScanTable(t))), DATA)


# ---- DISTINCT --------------------------------------------------------------

@pytest.mark.parametrize("inp", ["v", "f", "s"])
def test_distinct_group_by_matches_jax(inp):
    """DISTINCT SUM/COUNT by a nullable key over INT64, DOUBLE (-0.0 and
    +0.0 one value, each NaN its own) and STRING inputs with NULLs, beside
    a plain SUM and a MIN of the same column."""
    def make(ns, t):
        specs = [_spec(ns, "COUNT", inp, "dc", distinct=True),
                 _spec(ns, "COUNT", inp, "c"), _spec(ns, "MIN", inp, "mn")]
        if inp != "s":
            specs += [_spec(ns, "SUM", inp, "ds", distinct=True),
                      _spec(ns, "SUM", inp, "sm")]
        return ns.GroupAggregate(["k"], specs, ns.ScanTable(t))

    got, want = _both(make)
    _close_rows(got, want, {4, 5} if inp == "f" else set())


def test_distinct_double_nan_and_signed_zero_counts():
    """One group: +0.0, -0.0, 1.5, 1.5, NaN, NaN and a NULL count as four
    distinct values (the zeros are one, each NaN is its own)."""
    cols = (("k", "INT64", True), ("f", "DOUBLE", True))
    pair = tables(J, T, cols, {
        "k": (np.zeros(7, np.int64), np.ones(7, bool)),
        "f": (np.array([0.0, -0.0, 1.5, 1.5, np.nan, np.nan, 9.0]),
              np.array([1, 1, 1, 1, 1, 1, 0], bool))})
    rows = same_rows(J, T, lambda ns, t: ns.GroupAggregate(
        ["k"], [_spec(ns, "COUNT", "f", "dc", distinct=True)],
        ns.ScanTable(t)), pair)
    assert rows == [(0, 4)]


# ---- max_unique_keys_in_result --------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 5, 13, 400])
def test_max_unique_keys_matches_jax(K):
    """Groups past K, in insertion order, fold into group K - 1: SUM and
    COUNT add, MIN and MAX fold, validity ORs; K past the group count (13
    with the NULL key) or the capacity changes nothing."""
    def make(ns, t):
        return ns.GroupAggregate(
            ["k"], [_spec(ns, "SUM", "v", "sv"), _spec(ns, "COUNT", None, "c"),
                    _spec(ns, "COUNT", "v", "cv"), _spec(ns, "MIN", "v", "mn"),
                    _spec(ns, "MAX", "f", "mx"), _spec(ns, "FIRST", "s", "fs"),
                    _spec(ns, "LAST", "x", "lx")], ns.ScanTable(t),
            ns.GroupAggregateOptions(max_unique_keys_in_result=K))

    rows = same_rows(J, T, make, DATA)
    assert len(rows) == min(K, 13)


def test_max_unique_keys_example():
    cols = (("k", "INT64", False), ("v", "INT64", False))
    pair = tables(J, T, cols, {"k": np.array([1, 2, 3, 4]),
                               "v": np.ones(4, np.int64)})
    rows = same_rows(J, T, lambda ns, t: ns.GroupAggregate(
        ["k"], [_spec(ns, "SUM", "v", "s")], ns.ScanTable(t),
        ns.GroupAggregateOptions(max_unique_keys_in_result=2)), pair)
    assert rows == [(1, 1), (2, 3)]


# ---- memory quotas ---------------------------------------------------------

def _quota_plan(ns, t, cls, quota, enforce=False, distinct=False,
                max_keys=None):
    """A group-by of every aggregation under a memory quota.  No MIN/MAX
    reads f: past the quota each row is a group, and which of two tied
    values (-0.0 and +0.0) it gets is the tie order of the JAX package's
    unstable value sort."""
    specs = [_spec(ns, "SUM", "v", "sv"), _spec(ns, "COUNT", None, "c"),
             _spec(ns, "MIN", "v", "mn"), _spec(ns, "MAX", "x", "mx"),
             _spec(ns, "FIRST", "s", "fs"), _spec(ns, "LAST", "x", "lx")]
    if distinct:
        specs.append(_spec(ns, "COUNT", "v", "dc", distinct=True))
    return getattr(ns, cls)(["k"], specs, ns.ScanTable(t),
                            ns.GroupAggregateOptions(
                                memory_quota=quota, enforce_quota=enforce,
                                max_unique_keys_in_result=max_keys))


def test_quota_rows_match_jax():
    """The quota's row budget: the quota over the output row's width."""
    for cols in ((("a", "INT64", False), ("b", "DOUBLE", True)),
                 (("s", "STRING", True), ("c", "UINT64", False),
                  ("f", "FLOAT", False))):
        for quota in (1, 100, 12345):
            assert TA._quota_rows(quota, schema(T, cols)) == \
                JA._quota_rows(quota, schema(J, cols))


@pytest.mark.parametrize("rows", [3, 7, 20])
def test_best_effort_quota_matches_jax(rows):
    """The first ``rows`` keys in sort order aggregate fully, every later
    row is a group of its own, with the warning; with room for every key
    the result is exact and nothing warns."""
    # k, sv, mn: 8 bytes and a validity byte; c: 8; mx, fs, lx: 4 and 1
    quota = rows * (3 * 9 + 8 + 3 * 5)
    got, want = _both(lambda ns, t: _quota_plan(ns, t,
                                                "BestEffortGroupAggregate",
                                                quota))
    assert bit_rows(got) == bit_rows(want)
    exact = T.execute(_quota_plan(T, DATA[1], "GroupAggregate", None))
    if rows >= 13:
        assert bit_rows(got) == bit_rows(exact.to_pylist())
    else:
        assert len(got) > 13
        # re-aggregating the partial groups gives the exact counts
        counts = {}
        for r in got:
            counts[r[0]] = counts.get(r[0], 0) + r[2]
        assert counts == {r[0]: r[2] for r in exact.to_pylist()}


@pytest.mark.parametrize("cls,enforce", [("GroupAggregate", False),
                                         ("BestEffortGroupAggregate", True),
                                         ("HybridGroupAggregate", False)])
def test_strict_quota_raises_like_jax(cls, enforce):
    """A strict quota (GroupAggregate, or best effort with enforce_quota)
    over more keys than it holds raises "aggregate result overflow"; a
    HybridGroupAggregate under a quota spills through the external sort
    and gives the JAX package's rows, in key order (a quota of 25-row
    chunks: the JAX package's spill takes ~20 s at 6-row ones)."""
    quota = 5 * 64
    if cls == "HybridGroupAggregate":
        same_rows(J, T, lambda ns, t: _quota_plan(ns, t, cls, 4 * quota),
                  DATA)
        return
    with pytest.raises(J.EvaluationError, match="aggregate result overflow"):
        J.execute(_quota_plan(J, DATA[0], cls, quota, enforce))
    with pytest.raises(T.exprs.base.EvaluationError,
                       match="aggregate result overflow"):
        T.execute(_quota_plan(T, DATA[1], cls, quota, enforce))
    # a quota with room for every key gives the exact result
    same_rows(J, T, lambda ns, t: _quota_plan(ns, t, cls, 10**6, enforce),
              DATA)


@pytest.mark.parametrize("what", ["distinct", "max_keys"])
def test_best_effort_quota_rejections(what):
    kw = {"distinct": True} if what == "distinct" else {"max_keys": 4}
    for ns, t in ((J, DATA[0]), (T, DATA[1])):
        with pytest.raises(ns.SchemaError):
            ns.execute(_quota_plan(ns, t, "BestEffortGroupAggregate", 500,
                                   **kw))


def test_hybrid_and_best_effort_without_quota_are_group_aggregate():
    for cls in ("HybridGroupAggregate", "BestEffortGroupAggregate"):
        rows = same_rows(J, T, lambda ns, t: getattr(ns, cls)(
            ["k"], [_spec(ns, "SUM", "v", "sv"),
                    _spec(ns, "COUNT", "v", "dc", distinct=True)],
            ns.ScanTable(t)), DATA)
        assert bit_rows(rows) == bit_rows(T.execute(T.GroupAggregate(
            ["k"], [_spec(T, "SUM", "v", "sv"),
                    _spec(T, "COUNT", "v", "dc", distinct=True)],
            T.ScanTable(DATA[1]))).to_pylist())
    assert T.HybridGroupAggregate(["k"], [], None,
                                  temporary_directory_prefix="x").temp_prefix \
        == "x"


# ---- CONCAT ----------------------------------------------------------------

def _concat_table():
    cols = (("g", "INT64", False), ("s", "STRING", True),
            ("v", "INT64", True))
    return tables(J, T, cols, {
        "g": np.array([2, 1, 2, 1, 3, 2, 4, 4]),
        "s": (np.array([0, 1, 0, 2, 3, 0, 0, 0], np.int32),
              np.array([1, 1, 0, 1, 1, 1, 0, 0], bool)),
        "v": (np.array([5, 6, 7, 0, 8, 9, 1, 1]),
              np.array([1, 1, 1, 0, 1, 1, 0, 0], bool))},
        {"s": ("a", "b", "c", "d")})


def test_concat_group_by_matches_jax():
    """"," joins in input order, NULLs skipped, an all-NULL group NULL,
    numbers printed, DISTINCT once each; a Sort over the result reads the
    codes."""
    pair = _concat_table()
    rows = same_rows(J, T, lambda ns, t: ns.GroupAggregate(
        ["g"], [_spec(ns, "CONCAT", "s", "cs"),
                _spec(ns, "CONCAT", "v", "cv"),
                _spec(ns, "CONCAT", "s", "csd", distinct=True),
                _spec(ns, "SUM", "v", "sv")], ns.ScanTable(t)), pair)
    assert rows == [(2, "a,a", "5,7,9", "a", 21), (1, "b,c", "6", "b,c", 6),
                    (3, "d", "8", "d", 8), (4, None, None, None, None)]
    rows = same_rows(J, T, lambda ns, t: ns.Sort([ns.SortKey("g")],
                     ns.GroupAggregate(["g"], [_spec(ns, "CONCAT", "s", "cs")],
                                       ns.ScanTable(t))), pair)
    assert rows == [(1, "b,c"), (2, "a,a"), (3, "d"), (4, None)]


@pytest.mark.parametrize("route", ["native", "python"])
def test_concat_routes_match_jax(route, monkeypatch):
    """The C++ assembly and the Python loop give the JAX package's strings:
    DOUBLE and FLOAT values as the reference prints them (shortest
    round trip), BOOL and DATE formats, under ScalarAggregate and
    AggregateClusters too."""
    from supersonic_tpu_torch import native

    if route == "python":
        monkeypatch.setattr(native, "concat_groups", lambda *a: None)
    cols = (("g", "INT64", True), ("b", "BOOL", True), ("d", "DATE", True),
            ("f", "FLOAT", False), ("y", "DOUBLE", True))
    rng = np.random.default_rng(8)
    n = 40
    pair = tables(J, T, cols, {
        "g": (rng.integers(0, 4, n), rng.random(n) > 0.1),
        "b": (rng.random(n) > 0.5, rng.random(n) > 0.2),
        "d": (rng.integers(-400, 20000, n).astype(np.int32),
              rng.random(n) > 0.2),
        "f": (rng.standard_normal(n) * 1e3).astype(np.float32),
        "y": (rng.standard_normal(n) / 7, rng.random(n) > 0.2)})
    specs = lambda ns: [_spec(ns, "CONCAT", c, "c" + c) for c in "bdfy"] + [
        _spec(ns, "CONCAT", "f", "dist", distinct=True)]
    same_rows(J, T, lambda ns, t: ns.GroupAggregate(["g"], specs(ns),
                                                    ns.ScanTable(t)), pair)
    same_rows(J, T, lambda ns, t: ns.ScalarAggregate(specs(ns),
                                                     ns.ScanTable(t)), pair)
    same_rows(J, T, lambda ns, t: ns.AggregateClusters(["g"], specs(ns),
                                                       ns.ScanTable(t)), pair)
    assert T_host.concat_route == route


def test_concat_all_null_group_and_scalar():
    cols = (("g", "INT64", False), ("s", "STRING", True))
    pair = tables(J, T, cols, {"g": np.array([1, 1, 2]),
                               "s": (np.array([0, 0, 0], np.int32),
                                     np.array([0, 0, 1], bool))}, {"s": ("x",)})
    assert same_rows(J, T, lambda ns, t: ns.GroupAggregate(
        ["g"], [_spec(ns, "CONCAT", "s", "cs")], ns.ScanTable(t)), pair) == \
        [(1, None), (2, "x")]
    assert same_rows(J, T, lambda ns, t: ns.ScalarAggregate(
        [_spec(ns, "CONCAT", "s", "c")], ns.ScanTable(t)), pair) == [("x",)]


def test_concat_clusters_and_best_effort_match_jax():
    """CONCAT in AggregateClusters (runs stay apart) and in a best-effort
    group-by past its quota (later rows concatenate alone)."""
    pair = _concat_table()
    rows = same_rows(J, T, lambda ns, t: ns.AggregateClusters(
        ["g"], [_spec(ns, "CONCAT", "s", "cs")], ns.ScanTable(t)), pair)
    assert rows == [(2, "a"), (1, "b"), (2, None), (1, "c"), (3, "d"),
                    (2, "a"), (4, None)]
    got, want = _both(lambda ns, t: ns.BestEffortGroupAggregate(
        ["g"], [_spec(ns, "CONCAT", "s", "cs")], ns.ScanTable(t),
        ns.GroupAggregateOptions(memory_quota=2 * 13)), pair)
    assert got == want and len(got) > 4


def test_concat_rejections():
    """Sorting or grouping by a CONCAT result, a CONCAT under
    max_unique_keys_in_result and a CONCAT into another type raise
    SchemaError in both packages."""
    pair = _concat_table()
    for ns, t in zip((J, T), pair):
        plan = ns.GroupAggregate(["g"], [_spec(ns, "CONCAT", "s", "cs")],
                                 ns.ScanTable(t))
        with pytest.raises(ns.SchemaError, match="CONCAT"):
            ns.execute(ns.Sort([ns.SortKey("cs")], plan))
        with pytest.raises(ns.SchemaError, match="CONCAT"):
            ns.execute(ns.GroupAggregate(["cs"], [], plan))
        with pytest.raises(ns.SchemaError, match="CONCAT"):
            ns.execute(ns.GroupAggregate(
                ["g"], [_spec(ns, "CONCAT", "s", "cs")], ns.ScanTable(t),
                ns.GroupAggregateOptions(max_unique_keys_in_result=1)))
        with pytest.raises(ns.SchemaError, match="CONCAT"):
            ns.execute(ns.GroupAggregate(
                ["g"], [_spec(ns, "CONCAT", "s", "cs",
                              output_type=ns.DataType.INT64)],
                ns.ScanTable(t)))


# ---- the dense route's choice ---------------------------------------------

@pytest.mark.parametrize("case", ["distinct", "max_keys", "concat", "plain"])
def test_dense_route_choice_matches_jax(case):
    """DISTINCT, a key clamp and CONCAT leave the dense path in both
    packages; the same plan without them stays on it."""
    cols = (("k", "INT32", False), ("v", "INT32", False))
    pair = tables(J, T, cols, {"k": np.arange(8, dtype=np.int32) % 3,
                               "v": np.arange(8, dtype=np.int32)})

    def decide(ns, mod, t, opts):
        cb = ns.ScanTable(t).bind(ns.BindContext())
        spec = ("CONCAT" if case == "concat" else "SUM")
        specs = [_spec(ns, spec, "v", "o", distinct=case == "distinct")]
        return mod._dense_domain(cb, ["k"], [t.schema.lookup("k")], specs,
                                 t.schema, opts)

    maxk = 2 if case == "max_keys" else None
    jd = decide(J, JA, pair[0],
                J.GroupAggregateOptions(max_unique_keys_in_result=maxk))
    td = decide(T, TA, pair[1],
                T.GroupAggregateOptions(max_unique_keys_in_result=maxk))
    assert (td is None) == (jd is None) == (case != "plain")


def q6_plan(ns, t, lo=8766, hi=9131):
    """TPC-H Q6's shape: SUM(l_extendedprice * l_discount) and COUNT(*)
    over the rows a DATE range, a DOUBLE range and an INT32 bound keep."""
    c, C, D = ns.col, ns.Const, ns.DataType
    pred = ((c("l_shipdate") >= C(lo, D.DATE))
            & (c("l_shipdate") < C(hi, D.DATE))
            & (c("l_discount") >= C(0.05, D.DOUBLE))
            & (c("l_discount") <= C(0.07, D.DOUBLE))
            & (c("l_quantity") < C(24, D.INT32)))
    rev = (c("l_extendedprice") * c("l_discount")).as_("rev")
    return ns.ScalarAggregate(
        [_spec(ns, "SUM", "rev", "revenue"), _spec(ns, "COUNT", None, "n")],
        ns.Compute([rev], ns.Filter(pred, ns.ScanTable(t))))


@pytest.mark.parametrize("hi", [9131, 8766])
def test_q6_shape_scalar_matches_jax(hi):
    """The DATE, DOUBLE and INT32 comparisons of a Q6-shaped Filter under a
    ScalarAggregate; an empty date range keeps nothing (SUM NULL, COUNT
    0)."""
    rng = np.random.default_rng(6)
    n = 3000
    q = rng.integers(1, 51, n).astype(np.int32)
    cols = (("l_shipdate", "DATE", False), ("l_discount", "DOUBLE", False),
            ("l_quantity", "INT32", False),
            ("l_extendedprice", "DOUBLE", False))
    pair = tables(J, T, cols, {
        "l_shipdate": rng.integers(8036, 10562, n).astype(np.int32),
        "l_discount": rng.integers(0, 11, n) / 100,
        "l_quantity": q,
        "l_extendedprice": np.round(q * (900 + rng.random(n) * 1200), 2)})
    got, want = _both(lambda ns, t: q6_plan(ns, t, hi=hi), pair)
    _close_rows(got, want, {0})
    if hi == 8766:
        assert got == [(None, 0)]
    else:
        assert got[0][1] > 0


def _combo_tables():
    rng = np.random.default_rng(9)
    n = 300
    cols = (("k", "INT32", False), ("v", "INT64", True), ("s", "STRING", True),
            ("x", "FLOAT", False), ("fk", "INT32", False))
    fact = tables(J, T, cols, {
        "k": rng.integers(0, 20, n).astype(np.int32),
        "v": (rng.integers(-5, 6, n), rng.random(n) > 0.2),
        "s": (rng.integers(0, 4, n).astype(np.int32), rng.random(n) > 0.2),
        "x": rng.random(n).astype(np.float32),
        "fk": rng.integers(0, 50, n).astype(np.int32)},
        {"s": ("a", "bb", "c", "dd")})
    dim = tables(J, T, (("pk", "INT32", False), ("g", "INT64", True)),
                 {"pk": np.arange(40, dtype=np.int32),
                  "g": (rng.integers(0, 5, 40), rng.random(40) > 0.1)})
    return fact, dim


def _filtered(ns, t):
    return ns.Filter(ns.col("x") > ns.Const(0.3, ns.DataType.FLOAT),
                     ns.ScanTable(t))


def _join(ns, t, d, kind="INNER", filtered=True):
    return ns.HashJoin(getattr(ns.JoinType, kind), ["fk"], ["pk"],
                       _filtered(ns, t) if filtered else ns.ScanTable(t),
                       ns.ScanTable(d), ns.KeyUniqueness.UNIQUE)


COMBOS = {
    "best_effort_under_filter": lambda ns, t, d: ns.BestEffortGroupAggregate(
        ["k"], [_spec(ns, "SUM", "v", "sv"), _spec(ns, "MIN", "x", "mn"),
                _spec(ns, "CONCAT", "s", "cs")], _filtered(ns, t),
        ns.GroupAggregateOptions(memory_quota=5 * 18)),
    "clamp_statistics_key": lambda ns, t, d: ns.GroupAggregate(
        ["k"], [_spec(ns, "SUM", "v", "sv"), _spec(ns, "MAX", "x", "mx"),
                _spec(ns, "COUNT", None, "c")], _filtered(ns, t),
        ns.GroupAggregateOptions(max_unique_keys_in_result=7)),
    "distinct_masked_join": lambda ns, t, d: ns.GroupAggregate(
        ["g"], [_spec(ns, "COUNT", "v", "dv", distinct=True),
                _spec(ns, "SUM", "v", "sv", distinct=True),
                _spec(ns, "CONCAT", "s", "cs", distinct=True)],
        _join(ns, t, d)),
    "concat_under_sort": lambda ns, t, d: ns.Sort(
        [ns.SortKey("k")], ns.GroupAggregate(
            ["k"], [_spec(ns, "CONCAT", "v", "cv"),
                    _spec(ns, "COUNT", "s", "ds", distinct=True)],
            _filtered(ns, t))),
    "keyless_left_outer": lambda ns, t, d: ns.GroupAggregate(
        [], [_spec(ns, "SUM", "v", "sv"), _spec(ns, "CONCAT", "s", "cs")],
        _join(ns, t, d, "LEFT_OUTER", False)),
    "scalar_over_join": lambda ns, t, d: ns.ScalarAggregate(
        [_spec(ns, "SUM", "g", "sg"),
         _spec(ns, "COUNT", "g", "dg", distinct=True),
         _spec(ns, "LAST", "g", "lg")], _join(ns, t, d)),
    "clusters_over_limit": lambda ns, t, d: ns.AggregateClusters(
        ["s"], [_spec(ns, "SUM", "v", "sv"), _spec(ns, "FIRST", "x", "fx")],
        ns.Limit(10, 200, _filtered(ns, t))),
}


@pytest.mark.parametrize("name", list(COMBOS))
def test_option_combinations_match_jax(name):
    """The options over fused Filters, masked and LEFT_OUTER joins, a
    Sort, a Limit and a key with statistics (which the clamp and DISTINCT
    take off the dense path)."""
    fact, dim = _combo_tables()
    got, want = _both(lambda ns, t: COMBOS[name](ns, t, dim[ns is T]), fact)
    assert bit_rows(got) == bit_rows(want)
