"""The port's join over every key type and probe route against the JAX
package, both on the CPU: the merge probe (forced, and taken naturally by
sparse keys, a computed build side, float and BOOL keys, a dictionary past
the dense range), STRING/BINARY keys with separate dictionaries, ENUM,
DATE and DATETIME keys, multi-key tuples, the masked binding under
GroupAggregate and Sort, and a NOT_UNIQUE expansion over more lanes than
one launch moves.  A join moves values and computes none, so the rows must
be equal in order, values bit for bit, NULLs equal.  The JAX package runs
its CPU routes here (no interpret-mode kernel): the group-bys over a join
read a DOUBLE or a nullable key, which send it to its sort path."""
import functools

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu.ops.hash_join as JH
import supersonic_tpu_torch as T
import supersonic_tpu_torch.ops.hash_join as TH
from supersonic_tpu_torch.ops.base import RunContext

from torch_parity import same_rows, tables

torch.set_num_threads(1)

_pair = functools.partial(tables, J, T)  # (JAX table, port table)
_same_rows = functools.partial(same_rows, J, T)


@pytest.fixture
def routes(monkeypatch):
    """{probe: calls} of the port's merge, CSR and fat-LUT probes."""
    calls = {"merge": 0, "csr": 0, "fat_lut": 0}
    for key, name in (("merge", "_merge_probe"), ("csr", "_csr_probe"),
                      ("fat_lut", "_fat_lut_probe")):
        orig = getattr(TH, name)

        def wrap(*a, orig=orig, key=key, **kw):
            calls[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(TH, name, wrap)
    return calls


def _join(jt, uniq, lk, rk, dense=True, lhs=None, rhs=None, **kw):
    def make(ns, l, r):
        return ns.HashJoin(
            getattr(ns.JoinType, jt), lk, rk,
            lhs(ns, l) if lhs else ns.ScanTable(l),
            rhs(ns, r) if rhs else ns.ScanTable(r),
            getattr(ns.KeyUniqueness, uniq), allow_dense_lookup=dense, **kw)
    return make


LCOLS = (("k", "INT64", True), ("x", "DOUBLE", True), ("s", "STRING", False))
RCOLS = (("k2", "INT64", True), ("y", "INT32", True))
WORDS = tuple(f"w{i}" for i in range(7))


def _sides(uniq, scale=1, seed=3, n=90, m=40):
    """A probe side (nullable INT64 key, nullable DOUBLE, STRING) and a
    build side (nullable INT64 key, nullable INT32; keys on several rows
    unless UNIQUE), keys times ``scale``."""
    rng = np.random.default_rng(seed)
    if uniq == "UNIQUE":
        k2 = rng.permutation(60)[:m]
    else:
        k2 = rng.integers(0, 30, m)
    lhs = {"k": (rng.integers(0, 35, n) * scale, rng.random(n) < 0.9),
           "x": (rng.random(n), rng.random(n) < 0.8),
           "s": rng.integers(0, len(WORDS), n).astype(np.int32)}
    rhs = {"k2": (k2 * scale, rng.random(m) < 0.9),
           "y": (rng.integers(-99, 99, m).astype(np.int32),
                 rng.random(m) < 0.8)}
    return (_pair(LCOLS, lhs, {"s": WORDS}), _pair(RCOLS, rhs))


@pytest.mark.parametrize("route", ["forced", "natural"])
@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
@pytest.mark.parametrize("jt", ["INNER", "LEFT_OUTER"])
def test_merge_probe_matches_jax(routes, jt, uniq, route):
    """The merge probe forced (``allow_dense_lookup=False``) and taken
    because the keys have no dense domain: for INNER, 64-bit ids 10^9
    apart; for LEFT_OUTER, a computed build side without statistics, with a
    Filter fused on the lhs (so the LEFT_OUTER output is compacted)."""
    if route == "natural":
        route = "sparse" if jt == "INNER" else "computed"
    scale = 10**9 + 7 if route == "sparse" else 1
    l, r = _sides(uniq, scale)
    lhs = rhs = None
    if route == "computed":
        def lhs(ns, t):
            return ns.Filter(ns.col("x") > ns.Const(0.3, ns.DataType.DOUBLE),
                             ns.ScanTable(t))

        def rhs(ns, t):
            return ns.Compute([ns.col("k2"), ns.col("y")], ns.ScanTable(t))
    rows = _same_rows(_join(jt, uniq, ["k"], ["k2"], route != "forced",
                            lhs, rhs, out_capacity=600), l, r)
    assert routes == {"merge": 1, "csr": 0, "fat_lut": 0}
    assert any(row[3] is not None for row in rows)


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
def test_multi_key_int64_and_string(routes, uniq, dense):
    """(INT64, STRING) key tuples over separate dictionaries.  Dense:
    statistics times the probe dictionary's codes; else the merge probe
    over both codes.  (Build words the probe lacks: the next test.)"""
    rng = np.random.default_rng(8)
    n, m = 120, 50
    lw = ("ant", "bee", "cat", "dog", "eel", "fox", "gnu")
    rw = ("bee", "dog", "eel", "fox", "gnu")
    l = _pair((("a", "INT64", False), ("s", "STRING", True),
               ("x", "INT32", False)),
              {"a": rng.integers(0, 4, n),
               "s": (rng.integers(0, len(lw), n).astype(np.int32),
                     rng.random(n) < 0.9),
               "x": np.arange(n, dtype=np.int32)}, {"s": lw})
    if uniq == "UNIQUE":
        pairs = rng.permutation(4 * len(rw))[:m // 2]
        a2, s2 = pairs // len(rw), pairs % len(rw)
        m = len(pairs)
    else:
        a2, s2 = rng.integers(0, 4, m), rng.integers(0, len(rw), m)
    r = _pair((("a2", "INT64", False), ("s2", "STRING", False),
               ("y", "DOUBLE", True)),
              {"a2": a2, "s2": s2.astype(np.int32),
               "y": (rng.random(m), rng.random(m) < 0.8)}, {"s2": rw})
    for jt in ("INNER", "LEFT_OUTER"):
        _same_rows(_join(jt, uniq, ["a", "s"], ["a2", "s2"], dense,
                         out_capacity=2000), l, r)
    probe = ("fat_lut" if uniq == "UNIQUE" else "csr") if dense else "merge"
    assert routes[probe] == 2 and sum(routes.values()) == 2


@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
def test_absent_build_words_do_not_fire_the_range_guard(routes, uniq):
    """An (INT64, STRING) key whose build side holds words the probe's
    dictionary lacks: they map to -1 and match nothing, and only the
    statistics-planned INT64 dimension is guarded.  The dense probe gives
    the merge probe's rows, which are the JAX package's.  (The JAX
    package's dense route raises "join build keys exceed planned dense
    range" here: its guard covers the dictionary dimension too.)"""
    rng = np.random.default_rng(18)
    n, m = 100, 30
    lw = ("ant", "bee", "cat", "dog")
    rw = ("bee", "cow", "dog", "elk")
    l = _pair((("a", "INT64", False), ("s", "STRING", False)),
              {"a": rng.integers(0, 3, n),
               "s": rng.integers(0, len(lw), n).astype(np.int32)}, {"s": lw})
    if uniq == "UNIQUE":
        pairs = rng.permutation(3 * len(rw))
        a2, s2 = pairs // len(rw), pairs % len(rw)
        m = len(pairs)
    else:
        a2, s2 = rng.integers(0, 3, m), rng.integers(0, len(rw), m)
    r = _pair((("a2", "INT64", False), ("s2", "STRING", False),
               ("y", "INT32", False)),
              {"a2": a2, "s2": s2.astype(np.int32),
               "y": np.arange(m, dtype=np.int32)}, {"s2": rw})
    for jt in ("INNER", "LEFT_OUTER"):
        want = _same_rows(_join(jt, uniq, ["a", "s"], ["a2", "s2"], False,
                                out_capacity=2000), l, r)
        got = T.execute(_join(jt, uniq, ["a", "s"], ["a2", "s2"], True,
                              out_capacity=2000)(T, l[1], r[1]))
        assert got.to_pylist() == want
        assert {row[3] for row in want} <= {"bee", "dog", None}
    assert routes["merge"] == 2 and sum(routes.values()) == 4


def _float_sides(typ, uniq):
    """Float keys with NaNs, both zeros, infinities and NULLs."""
    dt = np.float32 if typ == "FLOAT" else np.float64
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25],
                       dtype=dt)
    rng = np.random.default_rng(21)
    n = 80
    k = special[rng.integers(0, len(special), n)]
    if uniq == "UNIQUE":
        k2 = np.array([np.nan, 0.0, np.inf, -np.inf, 1.5, 7.0], dtype=dt)
    else:
        k2 = special[rng.integers(0, len(special), 25)]
    m = len(k2)
    k2_ok = rng.random(m) < 0.9
    k2_ok[k2 == 0] = True
    l = _pair((("k", typ, True), ("i", "INT32", False)),
              {"k": (k, rng.random(n) < 0.9),
               "i": np.arange(n, dtype=np.int32)})
    r = _pair((("k2", typ, True), ("y", "INT64", False)),
              {"k2": (k2, k2_ok),
               "y": np.arange(m, dtype=np.int64) * 10})
    return l, r


@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
@pytest.mark.parametrize("typ", ["FLOAT", "DOUBLE"])
def test_float_keys_nan_and_signed_zeros(routes, typ, uniq):
    """Float keys take the merge probe: a NaN matches nothing (not even a
    NaN), -0.0 matches +0.0, infinities match themselves."""
    l, r = _float_sides(typ, uniq)
    rows = _same_rows(_join("LEFT_OUTER", uniq, ["k"], ["k2"],
                            out_capacity=400), l, r)
    assert routes["merge"] == 1 and routes["csr"] + routes["fat_lut"] == 0
    for k, _i, k2, _y in rows:
        if k is not None and np.isnan(k):
            assert k2 is None
        if k2 is not None:
            assert k2 == k  # -0.0 == 0.0
    assert any(k == 0 and k2 == 0 and str(k) != str(k2)
               for k, _i, k2, _y in rows)
    _same_rows(_join("INNER", uniq, ["k"], ["k2"], out_capacity=400), l, r)


@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
@pytest.mark.parametrize("typ", ["BOOL", "DATE", "DATETIME"])
def test_bool_date_and_datetime_keys(routes, typ, uniq):
    """BOOL keys take the merge probe; DATE keys are dense over their
    statistics; DATETIME keys (microseconds, a day apart) take the merge
    probe.  Forced merge too."""
    rng = np.random.default_rng(4)
    n = 70
    if typ == "BOOL":
        dom = np.array([False, True])
    elif typ == "DATE":
        dom = np.arange(18000, 18012, dtype=np.int32)
    else:
        dom = (np.arange(9, dtype=np.int64) * 86_400_000_000
               + 1_600_000_000_000_000)
    if uniq == "UNIQUE":
        k2 = dom[rng.permutation(len(dom))[:max(len(dom) - 2, 1)]]
    else:
        k2 = dom[rng.integers(0, len(dom), 20)]
    m = len(k2)
    l = _pair((("k", typ, True), ("i", "INT32", False)),
              {"k": (dom[rng.integers(0, len(dom), n)], rng.random(n) < 0.9),
               "i": np.arange(n, dtype=np.int32)})
    r = _pair((("k2", typ, False), ("y", "INT32", True)),
              {"k2": k2, "y": (np.arange(m, dtype=np.int32),
                               rng.random(m) < 0.8)})
    for dense in (True, False):
        _same_rows(_join("LEFT_OUTER", uniq, ["k"], ["k2"], dense,
                         out_capacity=2000), l, r)
    assert routes["merge"] == (1 if typ == "DATE" else 2)
    assert sum(routes.values()) == 2


@pytest.mark.parametrize("share", ["shared", "separate"])
@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
def test_string_keys(routes, uniq, share):
    """STRING keys of a LEFT_OUTER join, dense over the probe dictionary: a
    shared dictionary needs no remap; separate ones remap the build side,
    whose values the probe lacks map to -1 and match nothing (no guard flag
    fires).  (INNER STRING joins: the multi-key tests.)"""
    rng = np.random.default_rng(17)
    lw = tuple(f"key_{i:03d}" for i in range(0, 40, 2))
    rw = tuple(f"key_{i:03d}" for i in range(0, 40, 3))
    if share == "shared":
        rw = lw
    n = 100
    m = len(rw) if uniq == "UNIQUE" else 45
    r_codes = (rng.permutation(len(rw))[:m] if uniq == "UNIQUE"
               else rng.integers(0, len(rw), m))
    shared = (J.Dictionary(lw), T.Dictionary(lw))
    l = _pair((("k", "STRING", True), ("i", "INT64", False)),
              {"k": (rng.integers(0, len(lw), n).astype(np.int32),
                     rng.random(n) < 0.9),
               "i": np.arange(n, dtype=np.int64)},
              {"k": shared if share == "shared" else lw})
    r = _pair((("k2", "STRING", False), ("y", "INT32", True)),
              {"k2": r_codes.astype(np.int32),
               "y": (np.arange(m, dtype=np.int32), rng.random(m) < 0.8)},
              {"k2": shared if share == "shared" else rw})
    make = _join("LEFT_OUTER", uniq, ["k"], ["k2"], out_capacity=800)
    rows = _same_rows(make, l, r)
    assert routes["merge"] == 0
    assert any(row[2] is not None for row in rows)
    # the same through the merge probe
    assert _same_rows(_join("LEFT_OUTER", uniq, ["k"], ["k2"], False,
                            out_capacity=800), l, r) == rows
    assert routes["merge"] == 1


@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
def test_binary_and_enum_keys(routes, uniq):
    """BINARY keys remap like STRING keys; ENUM keys are dense over the
    value map and read back as value names."""
    rng = np.random.default_rng(6)
    n = 60
    lb, rb = (b"\x00a", b"b", b"c\x00"), (b"b", b"c\x00", b"zz")
    colors = ("red", "green", "blue", "cyan")
    m = 3 if uniq == "UNIQUE" else 12
    rk = (rng.permutation(3)[:m] if uniq == "UNIQUE"
          else rng.integers(0, 3, m)).astype(np.int32)
    re = (rng.permutation(4)[:m] if uniq == "UNIQUE"
          else rng.integers(0, 4, m)).astype(np.int32)
    l = _pair((("b", "BINARY", False), ("e", "ENUM", True)),
              {"b": rng.integers(0, 3, n).astype(np.int32),
               "e": (rng.integers(0, 4, n).astype(np.int32),
                     rng.random(n) < 0.9)}, {"b": lb}, enums={"e": colors})
    r = _pair((("b2", "BINARY", False), ("e2", "ENUM", False),
               ("y", "INT32", False)),
              {"b2": rk, "e2": re, "y": np.arange(m, dtype=np.int32)},
              {"b2": rb}, enums={"e2": colors})
    for keys in ((["b"], ["b2"]), (["e"], ["e2"]), (["e", "b"], ["e2", "b2"])):
        rows = _same_rows(_join("LEFT_OUTER", uniq, *keys, out_capacity=500),
                          l, r)
    assert {row[1] for row in rows} <= set(colors) | {None}
    assert routes["merge"] == 0


def test_dictionary_past_the_dense_range_takes_the_merge_probe(
        routes, monkeypatch):
    """A STRING key whose dictionary has more codes than the dense range
    (2^24 slots; 8 here) takes the merge probe, in both packages."""
    monkeypatch.setattr(TH, "_DENSE_RANGE_MAX", 8)
    monkeypatch.setattr(JH, "_DENSE_RANGE_MAX", 8)
    words = tuple(f"v{i:02d}" for i in range(20))
    rng = np.random.default_rng(2)
    rr = _pair((("s2", "STRING", False), ("y", "INT32", False)),
               {"s2": rng.integers(0, 20, 30).astype(np.int32),
                "y": np.arange(30, dtype=np.int32)}, {"s2": words})
    ll = _pair((("s", "STRING", False),),
               {"s": rng.integers(0, 20, 50).astype(np.int32)},
               {"s": words})
    _same_rows(_join("INNER", "NOT_UNIQUE", ["s"], ["s2"], out_capacity=500),
               ll, rr)
    assert routes == {"merge": 1, "csr": 0, "fat_lut": 0}


@pytest.mark.parametrize("jt", ["INNER", "LEFT_OUTER"])
def test_duplicate_unique_rhs_under_the_merge_probe_takes_the_first_row(
        routes, jt):
    """A UNIQUE rhs that breaks its promise, under the merge probe: a probe
    row takes the FIRST rhs row of its key in rhs order, value and
    validity, as the JAX package's merge route does (the fat LUT takes the
    last)."""
    rng = np.random.default_rng(13)
    m, keys, n = 60, 20, 150
    pk = rng.integers(0, keys, m)
    r = rng.integers(-9, 9, m)
    r_ok = rng.random(m) < 0.7
    rt = _pair((("pk", "INT64", False), ("r", "INT64", True)),
               {"pk": pk, "r": (r, r_ok)})
    fk = rng.integers(0, keys + 5, n)
    lt = _pair((("fk", "INT64", False),), {"fk": fk})
    rows = _same_rows(_join(jt, "UNIQUE", ["fk"], ["pk"], False), lt, rt)
    assert routes["merge"] == 1
    first = {}
    for i, key in enumerate(pk.tolist()):
        first.setdefault(key, i)
    want = []
    for key in fk.tolist():
        if key in first:
            i = first[key]
            want.append((key, key, int(r[i]) if r_ok[i] else None))
        elif jt == "LEFT_OUTER":
            want.append((key, None, None))
    assert rows == want


@pytest.mark.parametrize("jt", ["INNER", "LEFT_OUTER"])
def test_masked_merge_join_under_group_aggregate(jt):
    """A UNIQUE merge-probe join binds masked under GroupAggregate: its
    keep mask folds into the aggregate's (a DOUBLE SUM and COUNT by a
    nullable build-side key)."""
    l, r = _sides("UNIQUE")

    def make(ns, lt, rt):
        A = ns.Aggregation
        agg = ns.GroupAggregate(
            ["y"], [ns.AggSpec(A.SUM, "x", "sx"),
                    ns.AggSpec(A.COUNT, None, "c")],
            _join(jt, "UNIQUE", ["k"], ["k2"], False,
                  lhs=lambda ns, t: ns.Filter(
                      ns.col("x") > ns.Const(0.2, ns.DataType.DOUBLE),
                      ns.ScanTable(t)))(ns, lt, rt))
        if ns is J:
            agg._pushdown_disabled = True  # the binding the port has
        return agg

    want = J.execute(make(J, l[0], r[0])).to_pylist()
    got = T.execute(make(T, l[1], r[1])).to_pylist()
    assert [(a[0], a[2]) for a in got] == [(b[0], b[2]) for b in want]
    np.testing.assert_allclose([a[1] for a in got if a[1] is not None],
                               [b[1] for b in want if b[1] is not None],
                               rtol=1e-12)


def test_masked_merge_join_under_sort():
    """A UNIQUE merge-probe LEFT_OUTER join binds masked under Sort."""
    l, r = _sides("UNIQUE", seed=9)

    def make(ns, lt, rt):
        return ns.Sort([ns.SortKey("y", ascending=False),
                        ns.SortKey("x", ascending=True)],
                       _join("LEFT_OUTER", "UNIQUE", ["k"], ["k2"],
                             False)(ns, lt, rt))

    _same_rows(make, l, r)


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("jt", ["INNER", "LEFT_OUTER"])
def test_not_unique_join_over_more_than_32_lhs_lanes(jt, dense):
    """Twenty nullable lhs columns (forty lanes, with the count, the
    offsets and the starts 43 or 44) move in two compaction launches
    against one mask, then two spread launches."""
    rng = np.random.default_rng(31)
    n, m = 40, 30
    cols = [("k", "INT32", False)] + [(f"c{j}", "INT32", True)
                                      for j in range(20)]
    arrays = {"k": rng.integers(0, 12, n).astype(np.int32)}
    for j in range(20):
        arrays[f"c{j}"] = (rng.integers(-99, 99, n).astype(np.int32),
                           rng.random(n) < 0.8)
    l = _pair(tuple(cols), arrays)
    r = _pair((("k2", "INT32", False), ("y", "INT64", False)),
              {"k2": rng.integers(0, 10, m).astype(np.int32),
               "y": np.arange(m, dtype=np.int64)})
    rows = _same_rows(_join(jt, "NOT_UNIQUE", ["k"], ["k2"], dense,
                            out_capacity=400), l, r)
    assert len(rows) > n // 2 and len(rows[0]) == 23


@pytest.mark.parametrize("dense", [True, False])
def test_mixed_int32_and_int64_keys(routes, dense):
    """An INT32 probe key against an INT64 build key (values past int32)
    compares as int64."""
    rng = np.random.default_rng(5)
    l = _pair((("k", "INT32", False),),
              {"k": rng.integers(-5, 20, 50).astype(np.int32)})
    r = _pair((("k2", "INT64", False), ("y", "INT32", False)),
              {"k2": np.array([3, 2**32 + 3, 7, -5, 7, 19]),
               "y": np.arange(6, dtype=np.int32)})
    _same_rows(_join("INNER", "NOT_UNIQUE", ["k"], ["k2"], dense), l, r)
    _same_rows(_join("LEFT_OUTER", "UNIQUE", ["k2"], ["k"], dense), r, l)
    # the INT64 build key spans past the dense budget either way
    assert routes["merge"] == (1 if dense else 2)


def test_key_type_checks():
    """A DOUBLE key against an INT64 key raises SchemaError in both
    packages; an INT64 key against a UINT64 key (COUNT's output) is two
    integer types and gives the JAX package's rows (the keys compare by
    their monotone codes in both)."""
    l, r = _sides("UNIQUE")
    for i, ns in enumerate((J, T)):
        with pytest.raises(ns.SchemaError, match="type mismatch"):
            _join("INNER", "UNIQUE", ["x"], ["k2"])(ns, l[i], r[i]).bind(
                ns.BindContext())

    def counted(ns, lt, rt):
        counts = ns.GroupAggregate(["k2"], [ns.AggSpec(
            ns.Aggregation.COUNT, None, "c")], ns.ScanTable(rt))
        return ns.HashJoin(ns.JoinType.LEFT_OUTER, ["k"], ["c"],
                           ns.ScanTable(lt), counts,
                           rhs_projector=ns.Projector.named("k2", "c"))
    rows = _same_rows(counted, l, r)
    assert rows and all(row[4] is None for row in rows)  # 1 + 2^63 != 1


def test_merge_probe_positions_past_int32_raise(monkeypatch):
    """Merge-probe positions stay int32: lhs + rhs capacity past the int32
    range raises at bind, never wraps (the limit lowered to 100 here)."""
    monkeypatch.setattr(TH, "I32_MAX", 100)
    l, r = _sides("UNIQUE")
    with pytest.raises(T.SchemaError, match="past int32"):
        _join("INNER", "UNIQUE", ["k"], ["k2"], False)(T, l[1], r[1]).bind(
            T.BindContext())


@pytest.mark.parametrize("side", ["build", "probe"])
@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
def test_merge_probe_empty_side(uniq, side):
    l, r = _sides(uniq)
    empty_l = _pair(LCOLS, {"k": np.zeros(0, np.int64),
                            "x": np.zeros(0), "s": np.zeros(0, np.int32)},
                    {"s": WORDS})
    empty_r = _pair(RCOLS, {"k2": np.zeros(0, np.int64),
                            "y": np.zeros(0, np.int32)})
    args = (l, empty_r) if side == "build" else (empty_l, r)
    rows = _same_rows(_join("LEFT_OUTER", uniq, ["k"], ["k2"], False,
                            out_capacity=200), *args)
    assert len(rows) == (90 if side == "build" else 0)


def test_row_id_probe_takes_date_keys(routes):
    """A DATE primary key that is the row position plus a constant takes
    the row-id probe, as in the JAX package."""
    rng = np.random.default_rng(1)
    r = _pair((("d2", "DATE", False), ("y", "INT32", False)),
              {"d2": np.arange(18000, 18030, dtype=np.int32),
               "y": rng.integers(0, 9, 30).astype(np.int32)})
    l = _pair((("d", "DATE", True),),
              {"d": (rng.integers(17990, 18040, 60).astype(np.int32),
                     rng.random(60) < 0.9)})
    assert "d2" in r[1].rowid
    _same_rows(_join("LEFT_OUTER", "UNIQUE", ["d"], ["d2"]), l, r)
    assert sum(routes.values()) == 0


def _merge_oracle(bkeys, blive, pkeys, plive):
    """numpy (count, lower, build_perm) of the merge probe: build_perm the
    live build rows in (key, row) order, lower the first position of a
    probe key's run in it, count its length (0 for a dead probe row or a
    NaN key)."""
    live = np.nonzero(blive)[0]
    perm = live[np.lexsort((live,) + tuple(k[live] for k in
                                           reversed(bkeys)))]
    tuples = [tuple(k[i] for k in bkeys) for i in perm]
    count = np.zeros(len(plive), np.int32)
    lower = np.zeros(len(plive), np.int32)
    for j in range(len(plive)):
        key = tuple(k[j] for k in pkeys)
        hits = [i for i, t in enumerate(tuples) if t == key]
        if plive[j] and hits:
            count[j], lower[j] = len(hits), hits[0]
    return count, lower, perm


@pytest.mark.parametrize("nkeys", [1, 2])
def test_merge_probe_against_numpy(nkeys):
    """The merge probe's (count, lower, build_perm) against a numpy oracle,
    with dead rows on both sides and float codes with NaNs (each NaN a run
    of its own)."""
    rng = np.random.default_rng(40 + nkeys)
    rc, lc = 70, 90
    bk = [rng.integers(0, 9, rc).astype(np.float64)]
    pk = [rng.integers(0, 11, lc).astype(np.float64)]
    bk[0][rng.random(rc) < 0.1] = np.nan
    pk[0][rng.random(lc) < 0.1] = np.nan
    if nkeys == 2:
        bk.append(rng.integers(0, 3, rc))
        pk.append(rng.integers(0, 3, lc))
    blive, plive = rng.random(rc) < 0.85, rng.random(lc) < 0.85
    count, lower, perm = TH._merge_probe(
        [torch.from_numpy(k) for k in bk], [torch.from_numpy(k) for k in pk],
        torch.from_numpy(blive), torch.from_numpy(plive))
    want = _merge_oracle(bk, blive, pk, plive)
    assert count.tolist() == want[0].tolist()
    hit = want[0] > 0  # lower is read only where a row matches
    assert lower.numpy()[hit].tolist() == want[1][hit].tolist()
    assert perm[:int(blive.sum())].tolist() == want[2].tolist()
    assert count.dtype == lower.dtype == perm.dtype == torch.int32


def test_merge_probe_row_count_stays_on_the_device():
    """A merge-probe plan's row count is a 0-d tensor on the table's
    device: nothing is read back before execute reads the flags."""
    l, r = _sides("NOT_UNIQUE")
    plan = _join("LEFT_OUTER", "NOT_UNIQUE", ["k"], ["k2"], False,
                 out_capacity=600)(T, l[1], r[1])
    bound = plan.bind(T.BindContext())
    out = bound.run(RunContext([l[1], r[1]]))
    assert isinstance(out.num_rows, torch.Tensor) and out.num_rows.dim() == 0


def test_build_dictionary_map_is_kept_for_the_next_bind():
    """The build side's map into the probe dictionary (a host pass over
    both) is computed once for a pair of dictionaries: a second bind reuses
    it; another probe dictionary gets its own."""
    lw, rw = ("a", "c", "e"), ("b", "c", "e", "f")
    dl, dl2, dr = T.Dictionary(lw), T.Dictionary(lw), T.Dictionary(rw)
    first = dr.codes_in(dl)
    assert first.tolist() == [-1, 1, 2, -1]
    assert dr.codes_in(dl) is first
    assert dr.codes_in(dl2) is not first
    assert dr.codes_in(dl2).tolist() == first.tolist()
    assert T.Dictionary(()).codes_in(dl).tolist() == [0]
