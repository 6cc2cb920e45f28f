"""The port's GroupAggregate against the JAX package, both on the CPU,
mirroring tests/test_aggregate.py: the sort path (nullable keys, keys
without statistics, more than 2048 slots, 64-bit and DOUBLE inputs, every
key type), its routing beside the dense path, and the dense path's
widened acceptance.  The same numpy columns, made from a seed, go through
the same plan built from either package.  Keys, counts, integer sums,
MIN/MAX/FIRST/LAST and NULLs must be equal; f32 sums within 1e-5 of
max(1, the group's sum of |v|), DOUBLE sums within 1e-12 of it.  Most
plans are shaped so that the JAX package also takes its sort path (its
dense path runs the segment-reduce kernel in interpret mode, seconds a
call)."""
import math
import warnings

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu.ops.aggregate as JA
import supersonic_tpu_torch as T
import supersonic_tpu_torch.ops.aggregate as TA

from torch_parity import bit_rows, schema, tables

torch.set_num_threads(1)

F32_TOL, F64_TOL = 1e-5, 1e-12


def _keyed(rows, nkeys):
    return [(r[:nkeys], r[nkeys:]) for r in rows]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    return a == b


def assert_rows_match(got, want, nkeys, tol=None, ordered=True):
    """Rows equal in order (or as sets of keys with ``ordered=False``):
    keys and every column exact, but the columns of ``tol``: name ->
    (rtol, {key tuple: (the group's exact sum, its sum of |x|)}), within
    rtol of max(1, the sum of |x|) of the exact sum (for a key not in it:
    of the JAX package's value, within rtol of max(1, |that value|))."""
    assert [(a.name, a.type.value, a.nullable) for a in got.schema] == \
        [(a.name, a.type.value, a.nullable) for a in want.schema]
    names = want.schema.names()[nkeys:]
    g, w = got.to_pylist(), want.to_pylist()
    assert len(g) == len(w)
    if not ordered:
        def sort_key(r):
            return tuple((x is None, x if x is not None else 0)
                         for x in r[:nkeys])
        g, w = sorted(g, key=sort_key), sorted(w, key=sort_key)
    for (gk, gv), (wk, wv) in zip(_keyed(g, nkeys), _keyed(w, nkeys)):
        assert all(_same(a, b) for a, b in zip(gk, wk)), (gk, wk)
        for name, a, b in zip(names, gv, wv):
            if tol and name in tol and a is not None and b is not None \
                    and not math.isnan(b):
                rtol, exact = tol[name]
                ref, s = exact.get(wk, (b, abs(b)))
                assert abs(a - ref) <= rtol * max(1.0, s), (wk, name, a, ref)
            else:
                assert (a is None) == (b is None) and (
                    a is None or _same(a, b)), (wk, name, a, b)


def group_sums(keys, x, valid=None, live=None):
    """{key tuple: (exact sum of x, sum of |x|)} over the rows (``keys``
    are (values, valid or None) pairs; a NULL key is None)."""
    parts: dict = {}
    n = x.shape[0]
    for i in range(n):
        if (live is not None and not live[i]) or (
                valid is not None and not valid[i]):
            continue
        k = tuple(None if (kv is not None and not kv[i]) else
                  (kvals[i].item() if hasattr(kvals[i], "item")
                   else kvals[i]) for kvals, kv in keys)
        parts.setdefault(k, []).append(float(x[i]))
    return {k: (math.fsum(p), math.fsum(abs(v) for v in p))
            for k, p in parts.items()}


def _run(plan_fn, jt, tt):
    return T.execute(plan_fn(T, tt)), J.execute(plan_fn(J, jt))


def _specs(ns, inputs):
    """Every aggregation over every (name, out_type) input."""
    A = ns.Aggregation
    out = [ns.AggSpec(A.COUNT, None, "cnt")]
    for name, out_t in inputs:
        kw = {} if out_t is None else {"output_type": getattr(ns.DataType,
                                                               out_t)}
        out += [ns.AggSpec(A.SUM, name, f"sum_{name}", **kw),
                ns.AggSpec(A.COUNT, name, f"cnt_{name}"),
                ns.AggSpec(A.MIN, name, f"min_{name}"),
                ns.AggSpec(A.MAX, name, f"max_{name}"),
                ns.AggSpec(A.FIRST, name, f"first_{name}"),
                ns.AggSpec(A.LAST, name, f"last_{name}")]
    return out


VALUE_COLS = (("i", "INT32", True), ("l", "INT64", False),
              ("f", "FLOAT", False), ("d", "DOUBLE", True))


def _values(rng, n):
    f = (np.round(rng.standard_normal(n) * 8) / 4).astype(np.float32)
    f[rng.random(n) < 0.05] = -0.0
    d = rng.standard_normal(n) * 1e6
    d[rng.random(n) < 0.05] = 0.0
    return {"i": (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
                  rng.random(n) > 0.15),
            "l": rng.integers(-2**62, 2**62, n),
            "f": f, "d": (d, rng.random(n) > 0.15)}


def _key_column(rng, kind, n, nkeys):
    """(values, valid, dict values or None) of a nullable key of ``kind``
    with about ``nkeys`` distinct values."""
    valid = rng.random(n) > 0.1
    if kind in ("STRING", "BINARY"):
        words = sorted({f"w{i:04d}" for i in range(nkeys)})
        if kind == "BINARY":
            words = [w.encode() for w in words]
        return rng.integers(0, nkeys, n).astype(np.int32), valid, words
    if kind == "BOOL":
        return rng.random(n) < 0.5, valid, None
    if kind in ("FLOAT", "DOUBLE"):
        x = rng.integers(-nkeys // 2, nkeys // 2, n).astype(
            np.float32 if kind == "FLOAT" else np.float64) / 4
        x[rng.random(n) < 0.05] = -0.0  # groups with +0.0
        ibits = np.int32 if kind == "FLOAT" else np.int64
        bits = x.view(ibits)
        qnan = 0x7FC00000 if kind == "FLOAT" else 0x7FF8000000000000
        sign = -2**31 if kind == "FLOAT" else -2**63
        for where, b in ((rng.random(n) < 0.01, qnan),
                         (rng.random(n) < 0.01, qnan | sign)):
            bits[where] = b  # NaN keys of both signs, by their bits
        return x, valid, None
    dt = np.int32 if kind == "INT32" else np.int64
    base = 0 if kind == "INT32" else 2**40
    return (rng.integers(0, nkeys, n) + base).astype(dt), valid, None


KINDS = ["INT32", "INT64", "FLOAT", "DOUBLE", "BOOL", "STRING", "BINARY"]


@pytest.mark.parametrize("kind", KINDS)
def test_sort_path_key_types_match_jax(kind):
    """A nullable key of each type (the sort path in both packages), every
    aggregation over INT32, INT64, FLOAT and DOUBLE inputs, in insertion
    order; float keys with +-0 (one group) and NaNs of both signs (a group
    each)."""
    rng = np.random.default_rng(40 + KINDS.index(kind))
    n = 1500
    kv, kvalid, words = _key_column(rng, kind, n, 200)
    cols = (("k", kind, True),) + VALUE_COLS
    data = dict(_values(rng, n), k=(kv, kvalid))
    jt, tt = tables(J, T, cols, data,
                    None if words is None else {"k": words})

    def plan(ns, t):
        return ns.GroupAggregate(
            ["k"], _specs(ns, [(c, None) for c, _, _ in VALUE_COLS]),
            ns.ScanTable(t))

    got, want = _run(plan, jt, tt)
    dv, dvalid = data["d"]
    keys = [(kv if words is None else np.array(words, object)[kv], kvalid)]
    tol = {"sum_f": (F32_TOL, group_sums(keys, data["f"])),
           "sum_d": (F64_TOL, group_sums(keys, dv, dvalid))}
    assert_rows_match(got, want, 1, tol)
    if kind in ("FLOAT", "DOUBLE"):
        nans = int((np.isnan(kv) & kvalid).sum())
        got_nan = sum(1 for r in got.to_pylist()
                      if r[0] is not None and math.isnan(r[0]))
        assert got_nan == nans > 0


def test_multi_key_groups_match_jax():
    """Three keys (nullable INT32, STRING, DOUBLE with +-0): the sort path;
    a composite of multi-valued keys."""
    rng = np.random.default_rng(21)
    n = 2000
    k1, v1, _ = _key_column(rng, "INT32", n, 6)
    k2, _, words = _key_column(rng, "STRING", n, 5)
    k3 = rng.integers(-2, 3, n).astype(np.float64)
    k3[k3 == 0] = np.where(rng.random(int((k3 == 0).sum())) < 0.5, -0.0,
                           0.0)
    cols = (("k1", "INT32", True), ("k2", "STRING", False),
            ("k3", "DOUBLE", False)) + VALUE_COLS
    jt, tt = tables(J, T, cols, dict(_values(rng, n), k1=(k1, v1), k2=k2,
                                     k3=k3), {"k2": words})

    def plan(ns, t):
        return ns.GroupAggregate(
            ["k1", "k2", "k3"],
            _specs(ns, [("i", "INT64"), ("d", None), ("f", "DOUBLE")]),
            ns.ScanTable(t))

    got, want = _run(plan, jt, tt)
    assert int(got.num_rows) > 100
    assert_rows_match(got, want, 3, {"sum_f": (F32_TOL, {}),
                                     "sum_d": (F64_TOL, {})})


def test_more_than_2048_slots_match_jax():
    """A non-nullable INT32 key with statistics spanning 5000 slots: past
    the dense domain, so the sort path; FLOAT and INT32 inputs."""
    rng = np.random.default_rng(22)
    n = 6000
    k = rng.integers(-2500, 2500, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    x = rng.integers(-1000, 1000, n).astype(np.int32)
    cols = (("k", "INT32", False), ("v", "FLOAT", False),
            ("x", "INT32", False))
    jt, tt = tables(J, T, cols, {"k": k, "v": v, "x": x})

    def plan(ns, t):
        A = ns.Aggregation
        return ns.GroupAggregate(
            ["k"], [ns.AggSpec(A.SUM, "v", "sv"),
                    ns.AggSpec(A.SUM, "x", "sx"),
                    ns.AggSpec(A.MIN, "x", "mn"),
                    ns.AggSpec(A.COUNT, None, "c")], ns.ScanTable(t))

    got, want = _run(plan, jt, tt)
    assert_rows_match(got, want, 1,
                      {"sv": (F32_TOL, group_sums([(k, None)], v))})


def test_keys_without_statistics_match_jax():
    """Keys computed by a Compute have no planner statistics (in either
    package), so even a 5-value key takes the sort path; the Filter over
    it fuses into the aggregate's keep mask."""
    rng = np.random.default_rng(23)
    n = 3000
    a = rng.integers(0, 50, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    cols = (("a", "INT32", False), ("v", "FLOAT", False))
    jt, tt = tables(J, T, cols, {"a": a, "v": v})

    def plan(ns, t):
        A, col = ns.Aggregation, ns.col
        comp = ns.Compute([ns.ModulusSignaling(col("a"), ns.Const(5))
                           .as_("k"), col("v"), col("a")], ns.ScanTable(t))
        return ns.GroupAggregate(
            ["k"], [ns.AggSpec(A.SUM, "v", "sv"),
                    ns.AggSpec(A.MAX, "a", "mx"),
                    ns.AggSpec(A.LAST, "v", "lv")],
            ns.Filter(col("a") > ns.Const(7), comp))

    assert TA._dense_domain(
        T.Compute([T.col("a")], T.ScanTable(tt)).bind(T.BindContext()),
        ["a"], [tt.schema.lookup("a")], [], tt.schema) is None
    got, want = _run(plan, jt, tt)
    assert int(got.num_rows) == 5
    assert_rows_match(got, want, 1, {"sv": (F32_TOL, group_sums(
        [(a % 5, None)], v, live=a > 7))})


def test_unordered_under_sort_matches_jax():
    """Under a Sort the aggregate drops its insertion-order re-rank; the
    sorted rows match."""
    rng = np.random.default_rng(24)
    n = 3000
    k, kvalid, _ = _key_column(rng, "INT64", n, 300)
    cols = (("k", "INT64", True),) + VALUE_COLS
    jt, tt = tables(J, T, cols, dict(_values(rng, n), k=(k, kvalid)))

    def plan(ns, t):
        A = ns.Aggregation
        return ns.Sort([ns.SortKey("sl", False), ns.SortKey("k")],
                       ns.GroupAggregate(
                           ["k"], [ns.AggSpec(A.SUM, "l", "sl"),
                                   ns.AggSpec(A.MIN, "d", "md"),
                                   ns.AggSpec(A.COUNT, "i", "ci")],
                           ns.ScanTable(t)))

    got, want = _run(plan, jt, tt)
    assert_rows_match(got, want, 1)


@pytest.mark.parametrize("case", ["empty_input", "keep_nothing"])
def test_empty_results_match_jax(case):
    """No live row: no group, in both packages (an empty table, and a
    fused Filter that keeps nothing)."""
    cols = (("k", "INT32", True), ("d", "DOUBLE", False))
    n = 0 if case == "empty_input" else 50
    rng = np.random.default_rng(25)
    jt, tt = tables(J, T, cols, {
        "k": (rng.integers(0, 9, n).astype(np.int32), np.ones(n, bool)),
        "d": rng.random(n)}, capacity=64)

    def plan(ns, t):
        A = ns.Aggregation
        child = ns.ScanTable(t)
        if case == "keep_nothing":
            child = ns.Filter(ns.col("d") > ns.Const(2.0), child)
        return ns.GroupAggregate(["k"], [ns.AggSpec(A.SUM, "d", "sd"),
                                         ns.AggSpec(A.COUNT, None, "c"),
                                         ns.AggSpec(A.FIRST, "d", "fd")],
                                 child)

    got, want = _run(plan, jt, tt)
    assert got.to_pylist() == want.to_pylist() == []
    assert_rows_match(got, want, 1)


def test_result_overflow_raises_like_jax():
    """More groups than the planned result capacity raise "aggregate
    result overflow" on the sort path too."""
    cols = (("k", "INT64", True), ("v", "FLOAT", False))
    rng = np.random.default_rng(26)
    jt, tt = tables(J, T, cols, {
        "k": (rng.integers(0, 100, 500), np.ones(500, bool)),
        "v": rng.random(500).astype(np.float32)})

    def plan(ns, t):
        return ns.GroupAggregate(
            ["k"], [ns.AggSpec(ns.Aggregation.SUM, "v", "sv")],
            ns.ScanTable(t), ns.GroupAggregateOptions(
                estimated_result_row_count=10))

    with pytest.raises(J.EvaluationError, match="aggregate result overflow"):
        J.execute(plan(J, jt))
    with pytest.raises(T.EvaluationError, match="aggregate result overflow"):
        T.execute(plan(T, tt))


@pytest.mark.parametrize("out_t", ["INT32", "INT64"])
def test_integer_sums_wrap_like_jax(out_t):
    """An INT32 SUM into INT32 wraps modulo 2^32 and into INT64 does not;
    an INT64 SUM is exact past 2^53 and wraps modulo 2^64 (the reference
    sums in the output type)."""
    rng = np.random.default_rng(27)
    n = 4000
    k = rng.integers(0, 40, n)
    i = rng.integers(2**30, 2**31 - 1, n).astype(np.int32)
    l = rng.integers(2**61, 2**62, n)
    cols = (("k", "INT64", True), ("i", "INT32", False),
            ("l", "INT64", False))
    jt, tt = tables(J, T, cols, {"k": (k, np.ones(n, bool)), "i": i, "l": l})

    def plan(ns, t):
        A, D = ns.Aggregation, ns.DataType
        return ns.GroupAggregate(
            ["k"], [ns.AggSpec(A.SUM, "i", "si", getattr(D, out_t)),
                    ns.AggSpec(A.SUM, "l", "sl", getattr(D, out_t))],
            ns.ScanTable(t))

    got, want = _run(plan, jt, tt)
    assert_rows_match(got, want, 1)
    bits = 32 if out_t == "INT32" else 64
    for key, si, sl in got.to_pylist():
        for x, s in ((i, si), (l, sl)):
            exact = int(x[k == key].astype(object).sum())
            wrapped = (exact + 2**(bits - 1)) % 2**bits - 2**(bits - 1)
            assert s == wrapped


def test_double_sum_after_a_group_of_huge_values():
    """A first group of 1e300-scale values, then small groups: each group
    is added on its own in f64, within 1e-12 of its sum of |d| (math.fsum).
    The difference of a global prefix sum would leave the small groups with
    nothing.  (Held against fsum, not the JAX package, whose fixed-point
    sum quantizes every value against the largest.)"""
    rng = np.random.default_rng(28)
    n = 3000
    k = np.sort(rng.integers(0, 30, n))
    d = rng.standard_normal(n)
    d[k == 0] *= 1e300
    cols = (("k", "INT64", True), ("d", "DOUBLE", False))
    _, tt = tables(J, T, cols, {"k": (k, np.ones(n, bool)), "d": d})
    got = T.execute(T.GroupAggregate(
        ["k"], [T.AggSpec(T.Aggregation.SUM, "d", "sd")], T.ScanTable(tt)))
    rows = got.to_pylist()
    assert [r[0] for r in rows] == list(range(30))
    for key, sd in rows:
        grp = d[k == key]
        assert abs(sd - math.fsum(grp)) <= F64_TOL * math.fsum(np.abs(grp))
        if key:
            assert abs(sd) < 1e3


def test_non_finite_sums_stay_in_their_groups():
    """DOUBLE: +inf, -inf, NaN and mixed infinities give inf, -inf and NaN
    to the groups holding them only, as in the JAX package; FLOAT: a NaN
    gives NaN to its own group only (numpy; the JAX package's f32 tile
    scan spreads it)."""
    k = np.repeat(np.arange(6), 4)
    d = np.ones(24)
    d[[0, 5, 9, 12, 13]] = [np.inf, -np.inf, np.nan, np.inf, -np.inf]
    f = np.ones(24, np.float32)
    f[9] = np.nan
    cols = (("k", "INT64", True), ("d", "DOUBLE", False),
            ("f", "FLOAT", False))
    jt, tt = tables(J, T, cols, {"k": (k, np.ones(24, bool)), "d": d,
                                 "f": f})

    def plan(ns, t):
        A = ns.Aggregation
        return ns.GroupAggregate(["k"], [ns.AggSpec(A.SUM, "d", "sd"),
                                         ns.AggSpec(A.SUM, "f", "sf")],
                                 ns.ScanTable(t))

    got, want = _run(plan, jt, tt)
    sd = [r[1] for r in got.to_pylist()]
    assert all(_same(a, r[1]) for a, r in zip(sd, want.to_pylist()))
    assert sd[0] == math.inf and sd[1] == -math.inf
    assert math.isnan(sd[2]) and math.isnan(sd[3]) and sd[4:] == [4.0, 4.0]
    sf = [r[2] for r in got.to_pylist()]
    assert math.isnan(sf[2]) and [x for j, x in enumerate(sf) if j != 2] == \
        [4.0] * 5


def test_first_last_and_string_outputs_match_jax():
    """FIRST and LAST take the first and last row of a group in input
    order, NULL values included; STRING MIN/MAX/FIRST/LAST outputs carry
    the input's dictionary."""
    rng = np.random.default_rng(29)
    n = 2000
    k, kvalid, _ = _key_column(rng, "INT32", n, 120)
    s, svalid, words = _key_column(rng, "STRING", n, 40)
    cols = (("k", "INT32", True), ("s", "STRING", True),
            ("d", "DOUBLE", True))
    d = rng.standard_normal(n)
    jt, tt = tables(J, T, cols, {"k": (k, kvalid), "s": (s, svalid),
                                 "d": (d, rng.random(n) > 0.3)},
                    {"s": words})

    def plan(ns, t):
        A = ns.Aggregation
        return ns.GroupAggregate(
            ["k"], [ns.AggSpec(A.FIRST, "d", "fd"),
                    ns.AggSpec(A.LAST, "d", "ld"),
                    ns.AggSpec(A.MIN, "s", "mins"),
                    ns.AggSpec(A.MAX, "s", "maxs"),
                    ns.AggSpec(A.FIRST, "s", "fs"),
                    ns.AggSpec(A.LAST, "s", "ls")], ns.ScanTable(t))

    got, want = _run(plan, jt, tt)
    assert_rows_match(got, want, 1)
    for name in ("mins", "maxs", "fs", "ls"):
        assert got.dicts[name].values == tuple(words)


def test_nullable_key_from_a_left_outer_join_matches_jax():
    """A LEFT_OUTER UNIQUE join's rhs column is nullable, so grouping by
    it takes the sort path over the masked join: unmatched rows form the
    NULL group."""
    rng = np.random.default_rng(30)
    n, m = 4000, 300
    fact_cols = (("fk", "INT32", False), ("v", "FLOAT", False))
    dim_cols = (("pk", "INT32", False), ("g", "INT32", False))
    fk = rng.integers(0, 2 * m, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    g = rng.integers(0, 9, m).astype(np.int32)
    jf, tf = tables(J, T, fact_cols, {"fk": fk, "v": v})
    jd, td = tables(J, T, dim_cols, {"pk": np.arange(m, dtype=np.int32),
                                     "g": g})

    def plan(ns, f, d):
        A = ns.Aggregation
        return ns.GroupAggregate(
            ["g"], [ns.AggSpec(A.SUM, "v", "sv"),
                    ns.AggSpec(A.COUNT, None, "c")],
            ns.HashJoin(ns.JoinType.LEFT_OUTER, ["fk"], ["pk"],
                        ns.ScanTable(f), ns.ScanTable(d),
                        ns.KeyUniqueness.UNIQUE,
                        lhs_projector=ns.Projector.named("v"),
                        rhs_projector=ns.Projector.named("g")))

    jp = plan(J, jf, jd)
    jp._pushdown_disabled = True
    got, want = T.execute(plan(T, tf, td)), J.execute(jp)
    assert None in [r[0] for r in got.to_pylist()]
    hit = fk < m
    assert_rows_match(got, want, 1, {"sv": (F32_TOL, group_sums(
        [(g[np.minimum(fk, m - 1)], hit)], v))})


def test_dense_string_keys_match_jax():
    """STRING and BINARY keys are dense by their dictionary's size in both
    packages: one keyed segment-reduce call (the JAX package's kernel runs
    in interpret mode here)."""
    rng = np.random.default_rng(31)
    n = 3000
    s, _, words = _key_column(rng, "STRING", n, 50)
    cols = (("s", "STRING", False), ("v", "FLOAT", False),
            ("i", "INT32", True))
    v = rng.random(n).astype(np.float32)
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    jt, tt = tables(J, T, cols, {"s": s, "v": v,
                                 "i": (i, rng.random(n) > 0.2)},
                    {"s": words})

    def plan(ns, t):
        A = ns.Aggregation
        return ns.GroupAggregate(
            ["s"], [ns.AggSpec(A.SUM, "v", "sv"),
                    ns.AggSpec(A.MIN, "i", "mi"),
                    ns.AggSpec(A.COUNT, "i", "ci")], ns.ScanTable(t))

    bound = plan(T, tt)
    cb = T.ScanTable(tt).bind(T.BindContext())
    assert TA._dense_domain(cb, ["s"], [tt.schema.lookup("s")],
                            bound.spec.specs, tt.schema) == (
        [("s", tt.schema.lookup("s"), 0, 50)], 50)
    got, want = _run(plan, jt, tt)
    assert_rows_match(got, want, 1, {"sv": (F32_TOL, group_sums(
        [(np.array(words, object)[s], None)], v))})


def test_dense_widening_matches_jax():
    """The cases the JAX package's dense path takes that the port used to
    reject: an INT32 SUM into FLOAT, a FLOAT SUM into INT32, a FLOAT MIN into
    DOUBLE, BOOL inputs, FIRST and LAST of 64-bit columns.  One
    interpret-mode kernel call on the JAX side."""
    rng = np.random.default_rng(32)
    n = 2000
    cols = (("k", "INT32", False), ("i", "INT32", False),
            ("f", "FLOAT", True), ("b", "BOOL", False),
            ("d", "DOUBLE", False), ("l", "INT64", True))
    jt, tt = tables(J, T, cols, {
        "k": rng.integers(0, 30, n).astype(np.int32),
        "i": rng.integers(-100, 100, n).astype(np.int32),
        "f": ((rng.random(n) * 100).astype(np.float32), rng.random(n) > 0.2),
        "b": rng.random(n) < 0.3, "d": rng.standard_normal(n),
        "l": (rng.integers(-2**60, 2**60, n), rng.random(n) > 0.2)})

    def plan(ns, t):
        A, D = ns.Aggregation, ns.DataType
        return ns.GroupAggregate(
            ["k"], [ns.AggSpec(A.SUM, "i", "si_f", D.FLOAT),
                    ns.AggSpec(A.SUM, "f", "sf_i", D.INT32),
                    ns.AggSpec(A.MIN, "f", "mf_d", D.DOUBLE),
                    ns.AggSpec(A.MAX, "b", "mb"),
                    ns.AggSpec(A.SUM, "b", "sb", D.INT32),
                    ns.AggSpec(A.FIRST, "d", "fd"),
                    ns.AggSpec(A.LAST, "l", "ll")], ns.ScanTable(t))

    bound = plan(T, tt)
    cb = T.ScanTable(tt).bind(T.BindContext())
    assert TA._dense_domain(cb, ["k"], [tt.schema.lookup("k")],
                            bound.spec.specs, tt.schema) is not None
    got, want = _run(plan, jt, tt)
    assert_rows_match(got, want, 1)


def test_q1_shaped_group_by_is_dense_and_matches_jax():
    """TPC-H Q1's group-by: STRING keys of 3 and 2 codes (6 slots) over a
    Compute over a Filter, five DOUBLE SUMs (one integer-valued, as
    sum_qty) and COUNT(*) into INT64.  The port takes the dense route (the
    kernel's 64-bit sum words), the JAX package its sort path; the keys
    and the count equal, the DOUBLE sums within F64_TOL of each group's
    sum of |x|, the integer-valued one exact."""
    rng = np.random.default_rng(34)
    n = 6000
    rf = rng.choice(3, n, p=[0.25, 0.5, 0.25]).astype(np.int32)
    ls = np.where(rf == 1, (rng.random(n) < 0.99).astype(np.int32), 0)
    qty = rng.integers(1, 51, n).astype(np.float64)
    price = np.round(rng.random(n) * 1e5, 2)
    disc = rng.integers(0, 11, n) / 100
    tax = rng.integers(0, 9, n) / 100
    ship = rng.integers(8000, 10600, n).astype(np.int32)
    cols = (("rf", "STRING", False), ("ls", "STRING", False),
            ("qty", "DOUBLE", False), ("price", "DOUBLE", False),
            ("disc", "DOUBLE", False), ("tax", "DOUBLE", False),
            ("ship", "DATE", False))
    jt, tt = tables(J, T, cols, {"rf": rf, "ls": ls, "qty": qty,
                                 "price": price, "disc": disc, "tax": tax,
                                 "ship": ship},
                    {"rf": ("A", "N", "R"), "ls": ("F", "O")})

    def plan(ns, t):
        c, A, D = ns.col, ns.Aggregation, ns.DataType
        one = ns.Const(1.0, D.DOUBLE)
        keep = ns.Filter(c("ship") <= ns.Const(10400, D.DATE),
                         ns.ScanTable(t))
        dp = c("price") * (one - c("disc"))
        rows = ns.Compute([c("rf"), c("ls"), c("qty"), c("price"),
                           c("disc"), dp.as_("dp"),
                           (dp * (one + c("tax"))).as_("charge")], keep)
        return ns.GroupAggregate(
            ["rf", "ls"],
            [ns.AggSpec(A.SUM, "qty", "sum_qty"),
             ns.AggSpec(A.SUM, "price", "sum_price"),
             ns.AggSpec(A.SUM, "dp", "sum_dp"),
             ns.AggSpec(A.SUM, "charge", "sum_charge"),
             ns.AggSpec(A.SUM, "disc", "sum_disc"),
             ns.AggSpec(A.COUNT, None, "cnt", output_type=D.INT64)],
            rows, ns.GroupAggregateOptions(estimated_result_row_count=6))

    assert plan(T, tt).bind(T.BindContext()).route == "dense"
    got, want = _run(plan, jt, tt)
    live = ship <= 10400
    dp = price * (1.0 - disc)
    keys = [(np.array(["A", "N", "R"], object)[rf], None),
            (np.array(["F", "O"], object)[ls], None)]
    tol = {name: (F64_TOL, group_sums(keys, x, live=live))
           for name, x in (("sum_qty", qty), ("sum_price", price),
                           ("sum_dp", dp), ("sum_charge", dp * (1.0 + tax)),
                           ("sum_disc", disc))}
    assert_rows_match(got, want, 2, tol)
    exact = group_sums(keys, qty, live=live)
    assert {(r[0], r[1]): r[2] for r in got.to_pylist()} == {
        k: v[0] for k, v in exact.items()}


def test_int64_sums_over_two_keys_are_dense_and_match_jax():
    """SSB Q4.1's group-by shape: INT32 keys of 7 and 25 values (175
    slots), SUMs into INT64 of an INT32 input (past 2^31 a group), a
    nullable INT64 input (wrapping mod 2^64) and a DATE, and a FLOAT SUM
    into DOUBLE.  The port takes the dense route, the JAX package its sort
    path; the integer columns equal, the DOUBLE sum within F64_TOL of each
    group's sum of |x|.  A BOOL SUM into INT64 is held against numpy (the
    JAX package leaves row 0 out of a BOOL SUM on either of its routes)."""
    rng = np.random.default_rng(35)
    n = 8000
    year = rng.integers(1992, 1999, n).astype(np.int32)
    nation = rng.integers(0, 25, n).astype(np.int32)
    i = rng.integers(2**30, 2**31 - 1, n).astype(np.int32)
    lv = rng.random(n) > 0.2
    l = rng.integers(2**61, 2**62, n)
    f = (rng.standard_normal(n) * 100).astype(np.float32)
    cols = (("year", "INT32", False), ("nation", "INT32", False),
            ("i", "INT32", False), ("l", "INT64", True),
            ("b", "BOOL", False), ("dt", "DATE", False),
            ("f", "FLOAT", False))
    b = rng.random(n) < 0.4
    jt, tt = tables(J, T, cols, {
        "year": year, "nation": nation, "i": i, "l": (l, lv), "b": b,
        "dt": rng.integers(0, 20000, n).astype(np.int32), "f": f})

    def plan(ns, t, extra=()):
        A, D = ns.Aggregation, ns.DataType
        return ns.GroupAggregate(
            ["year", "nation"],
            [ns.AggSpec(A.SUM, "i", "si", D.INT64),
             ns.AggSpec(A.SUM, "l", "sl"),
             ns.AggSpec(A.SUM, "dt", "sdt", D.INT64),
             ns.AggSpec(A.SUM, "f", "sf", D.DOUBLE),
             ns.AggSpec(A.COUNT, "l", "cl"), *extra], ns.ScanTable(t))

    assert plan(T, tt).bind(T.BindContext()).route == "dense"
    got, want = _run(plan, jt, tt)
    keys = [(year, None), (nation, None)]
    assert_rows_match(got, want, 2, {"sf": (F64_TOL, group_sums(keys, f))})
    rows = got.to_pylist()
    assert len(rows) == 175
    for yr, nat, si, sl, *_ in rows:
        g = (year == yr) & (nation == nat)
        assert si == int(i[g].astype(object).sum()) and si > 2**31
        exact = int(l[g & lv].astype(object).sum())
        assert sl == (exact + 2**63) % 2**64 - 2**63
    with_bool = plan(T, tt, [T.AggSpec(T.Aggregation.SUM, "b", "sb",
                                       T.DataType.INT64)])
    assert with_bool.bind(T.BindContext()).route == "dense"
    for yr, nat, *_, sb in T.execute(with_bool).to_pylist():
        assert sb == int(b[(year == yr) & (nation == nat)].sum())


# (name, key column, key nullable, spec (aggregation, input, out type))
ROUTES = [
    ("int_key", "k", False, ("SUM", "f", None)),
    ("nullable_key", "kn", True, ("SUM", "f", None)),
    ("past_2048_slots", "kw", False, ("SUM", "f", None)),
    ("string_key", "s", False, ("MAX", "i", None)),
    ("binary_key", "bk", False, ("COUNT", None, None)),
    ("bool_key", "b", False, ("COUNT", None, None)),
    ("int64_input", "k", False, ("MIN", "l", None)),
    ("double_input", "k", False, ("MAX", "d", None)),
    ("sum_into_int64", "k", False, ("SUM", "i", "INT64")),
    ("sum_into_double", "k", False, ("SUM", "f", "DOUBLE")),
    ("sum_int32_into_float", "k", False, ("SUM", "i", "FLOAT")),
    ("min_float_into_double", "k", False, ("MIN", "f", "DOUBLE")),
    ("first_of_double", "k", False, ("FIRST", "d", None)),
    ("count_of_int64", "k", False, ("COUNT", "l", None)),
    ("max_of_bool", "k", False, ("MAX", "b", None)),
    ("double_sum", "k", False, ("SUM", "d", None)),
]
# SUMs into an 8-byte output: dense in the port (its kernel's 64-bit sum
# words), sort in the JAX package (the TPU has no 64-bit accumulators)
PORT_DENSE_ONLY = {"sum_into_int64", "sum_into_double", "double_sum"}


@pytest.mark.parametrize("name,key,nullable,spec", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_dense_or_sort_path_as_jax_chooses(name, key, nullable, spec):
    """The port sends a group-by to the dense path where the JAX package
    does (``_dense_domain`` of each, on the same bound scan), and to the
    sort path everywhere else, but for the SUMs into an 8-byte output of
    ``PORT_DENSE_ONLY``, which only the port takes densely."""
    rng = np.random.default_rng(33)
    n = 64
    cols = (("k", "INT32", False), ("kn", "INT32", True),
            ("kw", "INT64", False), ("s", "STRING", False),
            ("bk", "BINARY", False), ("b", "BOOL", False),
            ("i", "INT32", False), ("f", "FLOAT", False),
            ("l", "INT64", False), ("d", "DOUBLE", False))
    data = {"k": rng.integers(0, 10, n).astype(np.int32),
            "kn": (rng.integers(0, 10, n).astype(np.int32),
                   rng.random(n) > 0.2),
            "kw": np.arange(n) * 100,
            "s": rng.integers(0, 3, n).astype(np.int32),
            "bk": rng.integers(0, 3, n).astype(np.int32),
            "b": rng.random(n) < 0.5,
            "i": rng.integers(0, 9, n).astype(np.int32),
            "f": rng.random(n).astype(np.float32),
            "l": rng.integers(0, 9, n), "d": rng.random(n)}
    jt, tt = tables(J, T, cols, data, {"s": ("a", "b", "c"),
                                       "bk": (b"a", b"b", b"c")})
    agg, inp, out_t = spec

    def decide(ns, mod, t, extra):
        cb = ns.ScanTable(t).bind(ns.BindContext())
        kw = {} if out_t is None else {
            "output_type": getattr(ns.DataType, out_t)}
        specs = [ns.AggSpec(getattr(ns.Aggregation, agg), inp, "o", **kw)]
        return mod._dense_domain(cb, [key], [t.schema.lookup(key)], specs,
                                 t.schema, *extra)

    jd = decide(J, JA, jt, (J.GroupAggregateOptions(),))
    td = decide(T, TA, tt, ())
    if name in PORT_DENSE_ONLY:
        assert jd is None and td is not None
        assert td[1] == 10 and [(d[0], d[2], d[3]) for d in td[0]] == \
            [("k", 0, 10)]
        return
    assert (td is None) == (jd is None)
    if td is not None:
        assert td[1] == jd[1]  # K
        assert [(d[0], d[2], d[3]) for d in td[0]] == \
            [(d[0], d[2], d[3]) for d in jd[0]]


@pytest.mark.parametrize("make", [
    lambda ns, t: ns.GroupAggregate(
        ["k"], [ns.AggSpec(ns.Aggregation.SUM, "v", "s", distinct=True)],
        ns.ScanTable(t)),
    lambda ns, t: ns.GroupAggregate(
        ["k"], [ns.AggSpec(ns.Aggregation.CONCAT, "k", "s")],
        ns.ScanTable(t)),
    lambda ns, t: ns.GroupAggregate(
        ["k"], [ns.AggSpec(ns.Aggregation.SUM, "v", "s")], ns.ScanTable(t),
        ns.GroupAggregateOptions(max_unique_keys_in_result=3)),
    lambda ns, t: ns.GroupAggregate(
        [], [ns.AggSpec(ns.Aggregation.SUM, "v", "s")], ns.ScanTable(t)),
], ids=["distinct", "concat", "max_unique_keys", "no_group_keys"])
def test_item_12_options_still_raise(make):
    """DISTINCT, CONCAT, max_unique_keys_in_result and a group-by without
    keys (ROADMAP.md queue 1 item 12) no longer raise: each gives the JAX
    package's rows."""
    cols = (("k", "INT32", True), ("v", "FLOAT", False))
    jt, tt = tables(J, T, cols, {"k": (np.arange(4, dtype=np.int32) % 3,
                                       np.ones(4, bool)),
                                 "v": np.arange(4, dtype=np.float32) + 0.5})
    want, got = J.execute(make(J, jt)), T.execute(make(T, tt))
    assert [(a.name, a.type.value) for a in got.schema] == \
        [(a.name, a.type.value) for a in want.schema]
    assert got.to_pylist() == want.to_pylist()


def test_more_lanes_than_one_compaction_launch_match_jax():
    """17 nullable INT64 inputs, each summed and counted: 36 run-end lanes,
    past the 32 one compaction launch moves, so the run ends are extracted
    in two launches."""
    rng = np.random.default_rng(34)
    n, m = 1000, 17
    cols = (("k", "INT32", True),) + tuple(
        (f"x{j}", "INT64", True) for j in range(m))
    data = {"k": (rng.integers(0, 60, n).astype(np.int32),
                  rng.random(n) > 0.1)}
    for j in range(m):
        data[f"x{j}"] = (rng.integers(-2**40, 2**40, n), rng.random(n) > 0.3)
    jt, tt = tables(J, T, cols, data)

    def plan(ns, t):
        A = ns.Aggregation
        specs = []
        for j in range(m):
            specs += [ns.AggSpec(A.SUM, f"x{j}", f"s{j}"),
                      ns.AggSpec(A.COUNT, f"x{j}", f"c{j}")]
        return ns.GroupAggregate(["k"], specs, ns.ScanTable(t))

    got, want = _run(plan, jt, tt)
    assert_rows_match(got, want, 1)


def test_more_lanes_than_one_gather_launch_under_a_filter_match_jax():
    """17 nullable INT64 inputs and a nullable key under a fused Filter:
    36 lanes read at the live row ids, past the 32 one gather launch
    moves, so they are gathered in two launches."""
    rng = np.random.default_rng(38)
    n, m = 1000, 17
    cols = (("k", "INT32", True),) + tuple(
        (f"x{j}", "INT64", True) for j in range(m))
    data = {"k": (rng.integers(0, 60, n).astype(np.int32),
                  rng.random(n) > 0.1)}
    for j in range(m):
        data[f"x{j}"] = (rng.integers(-2**40, 2**40, n), rng.random(n) > 0.3)
    jt, tt = tables(J, T, cols, data)

    def plan(ns, t):
        A = ns.Aggregation
        specs = [ns.AggSpec(A.MAX, f"x{j}", f"m{j}") for j in range(m)]
        return ns.GroupAggregate(["k"], specs, ns.Filter(
            ns.col("k") > ns.Const(5, ns.DataType.INT32), ns.ScanTable(t)))

    got, want = _run(plan, jt, tt)
    assert 40 < int(got.num_rows) < 60
    assert_rows_match(got, want, 1)


def _dirty_compaction(monkeypatch):
    """Make the aggregate's compactions leave junk past the count, as the
    card's kernel may (its rows there are unspecified; the CPU version
    zero-fills them): out-of-range row numbers, NaNs, True."""
    real = TA.compact_kernel

    def dirty(payloads, mask, out_cap):
        outs, count = real(payloads, mask, out_cap)
        past = torch.arange(out_cap) >= count
        for o in outs:
            junk = (True if o.dtype == torch.bool else math.nan
                    if o.dtype.is_floating_point else torch.iinfo(o.dtype).max)
            o.masked_fill_(past, junk)
        return outs, count

    monkeypatch.setattr(TA, "compact_kernel", dirty)


@pytest.mark.parametrize("child", ["filter", "masked_join"])
def test_rows_past_the_sorted_count_are_never_read(monkeypatch, child):
    """A sort-path group-by over live rows chosen by a keep mask (a fused
    Filter, a masked UNIQUE join) by an INT64 key far above the row count:
    its sorted order comes from a compaction, whose rows past the count
    hold junk on the card.  With junk there, the rows still match JAX's."""
    _dirty_compaction(monkeypatch)
    rng = np.random.default_rng(35)
    n, m = 3000, 200
    k = rng.integers(0, 40, n) * 10**12 + 7 * 10**11
    d = (rng.standard_normal(n), rng.random(n) > 0.2)
    fk = rng.integers(0, 2 * m, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    cols = (("k", "INT64", False), ("d", "DOUBLE", True),
            ("fk", "INT32", False), ("v", "FLOAT", False))
    jt, tt = tables(J, T, cols, {"k": k, "d": d, "fk": fk, "v": v})
    dcols = (("pk", "INT32", False), ("w", "INT64", False))
    w = rng.integers(0, 40, m) * 10**12 + 5
    jd, td = tables(J, T, dcols, {"pk": np.arange(m, dtype=np.int32),
                                  "w": w})

    def plan(ns, t, dim):
        A, col = ns.Aggregation, ns.col
        specs = [ns.AggSpec(A.SUM, "d", "sd"), ns.AggSpec(A.COUNT, None, "c"),
                 ns.AggSpec(A.MIN, "v", "mn"), ns.AggSpec(A.MAX, "d", "mx"),
                 ns.AggSpec(A.FIRST, "d", "fd"), ns.AggSpec(A.LAST, "v", "lv")]
        if child == "filter":
            return ns.GroupAggregate(["k"], specs, ns.Filter(
                col("v") > ns.Const(0.4, ns.DataType.FLOAT), ns.ScanTable(t)))
        agg = ns.GroupAggregate(["w"], specs, ns.HashJoin(
            ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(t),
            ns.ScanTable(dim), ns.KeyUniqueness.UNIQUE,
            lhs_projector=ns.Projector.named("d", "v"),
            rhs_projector=ns.Projector.named("w")))
        if ns is J:
            agg._pushdown_disabled = True
        return agg

    got, want = T.execute(plan(T, tt, td)), J.execute(plan(J, jt, jd))
    if child == "filter":
        live, keys = v > 0.4, k
    else:
        live, keys = fk < m, w[np.minimum(fk, m - 1)]
    assert int(got.num_rows) == np.unique(keys[live]).shape[0] > 30
    assert_rows_match(got, want, 1, {"sd": (F64_TOL, group_sums(
        [(keys, None)], d[0], d[1], live))})


def test_run_sums_spread_long_runs_over_tiles():
    """The f64 run sums of the sort path: runs far longer than a tile,
    runs cut by tile edges, runs of no rows (between others and at the
    end) and rows past the runs; an inf and a NaN stay in their runs."""
    tile = 64
    lengths = [3 * tile + 5, 0, 1, tile - 1, tile, 2, 0, 5 * tile + 17, 9,
               0, 0]
    rng = np.random.default_rng(36)
    x = rng.standard_normal(sum(lengths) + 100) * 1e3
    ends = np.cumsum(lengths)
    x[ends[2] - 1] = np.inf          # the run of one row
    x[ends[4] - 3] = np.nan          # the run of a whole tile
    got = TA._run_sums(torch.from_numpy(x), torch.tensor(lengths),
                       tile).tolist()
    for j, (e, n) in enumerate(zip(ends, lengths)):
        run = x[e - n:e]
        want = math.fsum(run)
        if j == 4:
            assert math.isnan(got[j])
        elif j != 2:
            assert abs(got[j] - want) <= F64_TOL * max(
                1.0, math.fsum(np.abs(run))), (j, got[j], want)
    assert got[2] == math.inf and got[1] == got[6] == got[9] == 0.0


LIVE_ROWS, LIVE_DIM = 3000, 300
LIVE_COLS = (("r", "INT32", False), ("fk", "INT32", False),
             ("k", "INT64", True), ("v", "INT64", True),
             ("d", "DOUBLE", True), ("i", "INT32", True))


def _live_data():
    """The fact's columns: r is the row number, fk hits the dimension for
    about half the rows, k is a nullable INT64 key of 40 values far above
    the row count (so no planned domain)."""
    rng = np.random.default_rng(37)
    n = LIVE_ROWS
    return {"r": np.arange(n, dtype=np.int32),
            "fk": rng.integers(0, 2 * LIVE_DIM, n).astype(np.int32),
            "k": (rng.integers(0, 40, n) * 10**12 + 7, rng.random(n) > 0.05),
            "v": (rng.integers(-10**6, 10**6, n), rng.random(n) > 0.1),
            "d": (rng.standard_normal(n) * 1e6, rng.random(n) > 0.1),
            "i": (rng.integers(0, 50, n).astype(np.int32),
                  rng.random(n) > 0.1)}


def _live_child(ns, form, t, dim):
    """The group-by's input in each form the live rows come in: ``host``
    a table built on the host (a host row count), ``join`` a masked UNIQUE
    join (a keep mask), ``count`` a Compute over that join, which then
    compacts (a device count, Q4's shape), and a fused Filter keeping
    ``none``, ``all`` or only the ``high`` rows."""
    col = ns.col
    names = [c[0] for c in LIVE_COLS if c[0] != "fk"]
    if form == "host":
        return ns.ScanTable(t)
    if form in ("join", "count"):
        join = ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(t),
                           ns.ScanTable(dim), ns.KeyUniqueness.UNIQUE,
                           lhs_projector=ns.Projector.named(*names),
                           rhs_projector=ns.Projector.named("w"))
        return (join if form == "join"
                else ns.Compute([col(n) for n in names], join))
    edge = {"none": LIVE_ROWS, "all": 0, "high": LIVE_ROWS - 40}[form]
    return ns.Filter(col("r") >= ns.Const(edge, ns.DataType.INT32),
                     ns.ScanTable(t))


def _live_live(form, data):
    r, fk = data["r"], data["fk"]
    return {"host": r >= 0, "join": fk < LIVE_DIM, "count": fk < LIVE_DIM,
            "none": r < 0, "all": r >= 0, "high": r >= LIVE_ROWS - 40}[form]


def _live_plan(ns, mode, child):
    """Every aggregate kind the mode takes over ``child``, grouped by k:
    ``plain`` in insertion order with room for more groups than there are
    (absent slots after the re-rank), ``clamp`` under
    max_unique_keys_in_result, ``quota`` under a best-effort memory quota
    (no DISTINCT), ``clusters`` as AggregateClusters."""
    A = ns.Aggregation
    I64 = ns.DataType.INT64
    specs = [ns.AggSpec(A.SUM, "v", "sv", output_type=I64),
             ns.AggSpec(A.SUM, "d", "sd"), ns.AggSpec(A.COUNT, None, "c"),
             ns.AggSpec(A.COUNT, "d", "cd"), ns.AggSpec(A.MIN, "d", "mn"),
             ns.AggSpec(A.MAX, "v", "mx"),
             ns.AggSpec(A.SUM, "i", "dsi", output_type=I64, distinct=True),
             ns.AggSpec(A.CONCAT, "i", "ci"), ns.AggSpec(A.FIRST, "d", "fd"),
             ns.AggSpec(A.LAST, "i", "li")]
    if mode == "clamp":
        specs = [s for s in specs if s.aggregation != A.CONCAT]
    if mode == "quota":
        specs = [s for s in specs if not s.distinct]
    if mode == "clusters":
        return ns.AggregateClusters(["k"], specs, child)
    if mode == "quota":
        return ns.BestEffortGroupAggregate(
            ["k"], specs, child, ns.GroupAggregateOptions(memory_quota=600))
    opts = (ns.GroupAggregateOptions(estimated_result_row_count=120)
            if mode == "plain"
            else ns.GroupAggregateOptions(max_unique_keys_in_result=7))
    agg = ns.GroupAggregate(["k"], specs, child, opts)
    if ns is J:
        agg._pushdown_disabled = True
    return agg


@pytest.mark.parametrize("form,mode", [
    ("join", "plain"), ("count", "plain"), ("host", "plain"),
    ("none", "plain"), ("all", "plain"), ("high", "plain"),
    ("join", "clamp"), ("high", "clamp"), ("join", "quota"),
    ("count", "quota"), ("count", "clusters"), ("high", "clusters"),
    ("host", "clusters")])
def test_sort_path_over_live_rows_matches_jax(form, mode):
    """The sort path sorts and scans the live rows alone, however they
    come: the rows match the JAX package's, DOUBLE sums within the suite's
    tolerance, and they equal bit for bit the port's rows over a table
    built on the host of those live rows alone, in input order."""
    data = _live_data()
    jt, tt = tables(J, T, LIVE_COLS, data)
    dim = {"pk": np.arange(LIVE_DIM, dtype=np.int32),
           "w": np.arange(LIVE_DIM, dtype=np.int32)}
    dcols = (("pk", "INT32", False), ("w", "INT32", False))
    jd, td = tables(J, T, dcols, dim)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = T.execute(_live_plan(T, mode, _live_child(T, form, tt, td)))
        want = J.execute(_live_plan(J, mode, _live_child(J, form, jt, jd)))
        live = _live_live(form, data)
        kept = {name: (tuple(x[live] for x in a) if isinstance(a, tuple)
                       else a[live]) for name, a in data.items()}
        host = T.execute(_live_plan(T, mode, T.ScanTable(
            tables(J, T, LIVE_COLS, kept)[1])))
    k, d = data["k"], data["d"]
    # a clamp folds groups and a quota splits them: there, within the
    # tolerance of the JAX package's value
    exact = {"sd": (F64_TOL, group_sums([k], d[0], d[1], live)
                    if mode == "plain" else {})}
    assert_rows_match(got, want, 1, exact)
    assert bit_rows(got.to_pylist()) == bit_rows(host.to_pylist())
    assert int(got.num_rows) == (0 if form == "none" else int(host.num_rows))
