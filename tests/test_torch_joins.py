"""The port's multi-match (NOT_UNIQUE) and LEFT_OUTER joins against the JAX
package, both on the CPU: the same plan, built by one function from either
package, over the same seeded numpy tables.  A join moves values and
computes none, so the rows must be equal in order, values bit for bit,
NULLs equal.

Mirrors tests/test_hash_join.py (test_inner_multi, test_left_outer_multi,
test_left_outer_unique, test_null_keys_never_match,
test_not_unique_join_dense_csr_vs_merge_paths,
test_dense_csr_guard_flag_not_unique, test_rowid_direct_matches_merge,
test_projectors_select_columns, test_empty_build_side) and
tests/test_capacity_edges.py (test_not_unique_join_near_out_capacity,
test_not_unique_join_past_capacity_raises).  STRING payloads of the JAX
tests become INT64 here: the port has no STRING columns yet."""
import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu_torch import kernels

from torch_parity import (DIM_SCHEMA, FACT_SCHEMA, assert_grouped_equal,
                          headline_data, jax_raised, jax_table, predicate,
                          torch_raised, torch_table)

torch.set_num_threads(1)


def _both(cols, data):
    """(JAX table, port table) of the same host data."""
    return jax_table(J, cols, data), torch_table(T, cols, data)


def _same_rows(make, *tables, jax_kw=None):
    """Execute make(ns, *tables) in both packages; the rows must be equal
    in order (values bit for bit, NULLs equal), the schemas alike."""
    jt = [t[0] for t in tables]
    tt = [t[1] for t in tables]
    jplan = make(J, *jt)
    for k, v in (jax_kw or {}).items():
        setattr(jplan, k, v)
    want = J.execute(jplan)
    got = T.execute(make(T, *tt))
    assert [(a.name, a.type.value, a.nullable) for a in got.schema] == \
        [(a.name, a.type.value, a.nullable) for a in want.schema]
    rows = got.to_pylist()
    assert rows == want.to_pylist()
    return rows


# --- mirrors of tests/test_hash_join.py ------------------------------------

SIDES_L = (("fk", "INT64", True), ("lv", "DOUBLE", True))
SIDES_R = (("pk", "INT64", True), ("rv", "INT64", True))


def _sides():
    return (_both(SIDES_L, {"fk": [1, 2, None, 4, 2],
                            "lv": [0.1, 0.2, 0.3, 0.4, 0.5]}),
            _both(SIDES_R, {"pk": [2, 1, 3], "rv": [20, 10, 30]}))


def test_inner_multi():
    ls, rs = (("k", "INT64", True),), (("k2", "INT64", True),
                                       ("tag", "INT64", True))
    rows = _same_rows(
        lambda ns, l, r: ns.HashJoin(ns.JoinType.INNER, ["k"], ["k2"],
                                     ns.ScanTable(l), ns.ScanTable(r),
                                     ns.KeyUniqueness.NOT_UNIQUE),
        _both(ls, {"k": [7, 8, 7]}),
        _both(rs, {"k2": [7, 9, 7], "tag": [100, 200, 300]}))
    # matches per lhs row in rhs original order
    assert rows == [(7, 7, 100), (7, 7, 300), (7, 7, 100), (7, 7, 300)]


def test_left_outer_multi():
    ls, rs = (("k", "INT64", True),), (("k2", "INT64", True),
                                       ("tag", "INT64", True))
    rows = _same_rows(
        lambda ns, l, r: ns.HashJoin(ns.JoinType.LEFT_OUTER, ["k"], ["k2"],
                                     ns.ScanTable(l), ns.ScanTable(r),
                                     ns.KeyUniqueness.NOT_UNIQUE,
                                     out_capacity=8),
        _both(ls, {"k": [5, 7]}), _both(rs, {"k2": [7, 7], "tag": [1, 2]}))
    assert rows == [(5, None, None), (7, 7, 1), (7, 7, 2)]


def test_left_outer_unique():
    rows = _same_rows(
        lambda ns, l, r: ns.HashJoin(ns.JoinType.LEFT_OUTER, ["fk"], ["pk"],
                                     ns.ScanTable(l), ns.ScanTable(r),
                                     ns.KeyUniqueness.UNIQUE), *_sides())
    # NULL key and unmatched keys produce NULL rhs rows
    assert rows == [(1, 0.1, 1, 10), (2, 0.2, 2, 20), (None, 0.3, None, None),
                    (4, 0.4, None, None), (2, 0.5, 2, 20)]


def test_null_keys_never_match():
    rows = _same_rows(
        lambda ns, l, r: ns.HashJoin(ns.JoinType.INNER, ["k"], ["k2"],
                                     ns.ScanTable(l), ns.ScanTable(r)),
        _both((("k", "INT64", True),), {"k": [None, 1]}),
        _both((("k2", "INT64", True),), {"k2": [None, 1]}))
    assert rows == [(1, 1)]


def test_projectors_select_columns():
    rows = _same_rows(
        lambda ns, l, r: ns.HashJoin(
            ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(l),
            ns.ScanTable(r), ns.KeyUniqueness.UNIQUE,
            lhs_projector=ns.Projector.named("lv"),
            rhs_projector=ns.Projector([("rv", "name")])), *_sides())
    assert rows == [(0.1, 10), (0.2, 20), (0.5, 20)]


def test_empty_build_side():
    rows = _same_rows(
        lambda ns, l, r: ns.HashJoin(ns.JoinType.LEFT_OUTER, ["k"], ["k2"],
                                     ns.ScanTable(l), ns.ScanTable(r)),
        _both((("k", "INT64", True),), {"k": [1, 2]}),
        _both((("k2", "INT64", True),), {"k2": []}))
    assert rows == [(1, None), (2, None)]


@pytest.mark.parametrize("jt", ["INNER", "LEFT_OUTER"])
def test_not_unique_join_dense_csr_vs_merge_paths(jt):
    """The port's CSR probe against the JAX package's CSR and merge
    probes: nullable INT32 keys on both sides, duplicate build keys."""
    rng = np.random.default_rng(7)
    fk = rng.integers(0, 40, size=200).astype(object)
    pk = rng.integers(0, 30, size=100).astype(object)
    fk[rng.random(200) < 0.1] = None
    pk[rng.random(100) < 0.1] = None
    lhs = _both((("fk", "INT32", True), ("x", "INT64", True)),
                {"fk": list(fk), "x": list(range(200))})
    rhs = _both((("pk", "INT32", True), ("y", "INT64", True)),
                {"pk": list(pk), "y": list(range(100))})

    def make(ns, l, r):
        return ns.HashJoin(getattr(ns.JoinType, jt), ["fk"], ["pk"],
                           ns.ScanTable(l), ns.ScanTable(r),
                           ns.KeyUniqueness.NOT_UNIQUE, out_capacity=4096)

    rows = _same_rows(make, lhs, rhs)
    merge = J.execute(J.HashJoin(getattr(J.JoinType, jt), ["fk"], ["pk"],
                                 J.ScanTable(lhs[0]), J.ScanTable(rhs[0]),
                                 J.KeyUniqueness.NOT_UNIQUE,
                                 out_capacity=4096, allow_dense_lookup=False))
    assert rows == merge.to_pylist()
    assert len(rows) > 200  # duplicates actually expanded


def test_dense_csr_guard_flag_not_unique():
    ls, rs = (("fk", "INT32", False),), (("pk", "INT32", False),)
    lhs = _both(ls, {"fk": [3, 5, 3]})
    rhs = _both(rs, {"pk": [3, 3, 5, 9]})
    bad = _both(rs, {"pk": [3, 3, 1 << 22, 9]})  # outside the planned range

    def make(ns, l, r):
        return ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"], ns.ScanTable(l),
                           ns.ScanTable(r), ns.KeyUniqueness.NOT_UNIQUE,
                           out_capacity=16)

    assert jax_raised(make(J, lhs[0], rhs[0]), [lhs[0], rhs[0]]) == \
        torch_raised(make(T, lhs[1], rhs[1]), [lhs[1], rhs[1]]) == set()
    assert jax_raised(make(J, lhs[0], rhs[0]), [lhs[0], bad[0]]) == \
        torch_raised(make(T, lhs[1], rhs[1]), [lhs[1], bad[1]]) == \
        {"join build keys exceed planned dense range"}


@pytest.mark.parametrize("jt", ["LEFT_OUTER"])
def test_rowid_direct_matches_merge(jt):
    """kmin+9 is past the range, kmin-1 below it, a NULL key never
    matches; the port's row-id probe against both JAX probes."""
    kmin = 100
    lhs = _both((("fk", "INT64", True), ("lv", "DOUBLE", False)),
                {"fk": [kmin + 2, None, kmin - 1, kmin + 5, kmin + 9, kmin],
                 "lv": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]})
    rhs = _both((("pk", "INT64", False), ("rv", "INT32", False)),
                {"pk": np.arange(kmin, kmin + 6, dtype=np.int64),
                 "rv": np.arange(6, dtype=np.int32) * 10})
    assert "pk" in rhs[1].rowid
    outs = []
    for allow_dense in (True, False):
        outs.append(_same_rows(
            lambda ns, l, r: ns.HashJoin(getattr(ns.JoinType, jt), ["fk"],
                                         ["pk"], ns.ScanTable(l),
                                         ns.ScanTable(r),
                                         ns.KeyUniqueness.UNIQUE),
            lhs, rhs, jax_kw={"allow_dense_lookup": allow_dense}))
    assert outs[0] == outs[1]
    assert outs[0][1] == (None, 0.2, None, None)


# --- mirrors of tests/test_capacity_edges.py -------------------------------

def _dup_tables(n_probe=200, n_build=80, dup=4, seed=0):
    """build side has ``dup`` rows per key -> n_probe * dup output rows."""
    rng = np.random.default_rng(seed)
    probe = _both((("fk", "INT64", False), ("pv", "INT64", False)),
                  {"fk": rng.integers(0, n_build // dup, n_probe),
                   "pv": np.arange(n_probe)})
    build = _both((("bk", "INT64", False), ("bv", "INT64", False)),
                  {"bk": np.repeat(np.arange(n_build // dup), dup),
                   "bv": np.arange(n_build)})
    return probe, build


def _dup_join(cap):
    return lambda ns, p, b: ns.HashJoin(
        ns.JoinType.INNER, ["fk"], ["bk"], ns.ScanTable(p), ns.ScanTable(b),
        ns.KeyUniqueness.NOT_UNIQUE, out_capacity=cap)


@pytest.mark.parametrize("fill", [0.91, 1.0])
def test_not_unique_join_near_out_capacity(fill):
    probe, build = _dup_tables()
    exact = 200 * 4
    rows = _same_rows(_dup_join(int(np.ceil(exact / fill))), probe, build)
    assert len(rows) == exact


def test_not_unique_join_past_capacity_raises():
    probe, build = _dup_tables()
    exact = 200 * 4
    with pytest.raises(J.exprs.EvaluationError) as want:
        J.execute(_dup_join(exact - 1)(J, probe[0], build[0]))
    with pytest.raises(T.EvaluationError) as got:
        T.execute(_dup_join(exact - 1)(T, probe[1], build[1]))
    assert str(got.value) == str(want.value) == \
        "evaluation failed: join result overflow"


# --- the slice's plans ------------------------------------------------------

DUP_FACT = (("fk", "INT32", False), ("v", "FLOAT", False))
DUP_DIM = (("pk", "INT32", False), ("w", "INT32", False))


def _dup8_data(fact_rows=4096, dim_rows=1024, miss=1, seed=42):
    """The dup8 configuration at small size: dim pk = arange // 8 (8
    consecutive rows per key, ascending), w in [0, 64); fact fk uniform over
    ``miss`` times the key count (keys past it match nothing)."""
    rng = np.random.default_rng(seed)
    keys = dim_rows // 8
    fact = {"fk": rng.integers(0, keys * miss, fact_rows).astype(np.int32),
            "v": rng.random(fact_rows, dtype=np.float32)}
    dim = {"pk": (np.arange(dim_rows) // 8).astype(np.int32),
           "w": rng.integers(0, 64, dim_rows).astype(np.int32)}
    return _both(DUP_FACT, fact), _both(DUP_DIM, dim), fact, dim


def _dup8_join(jt, filtered, cap):
    def make(ns, f, d):
        lhs = ns.ScanTable(f)
        if filtered:
            lhs = ns.Filter(predicate(ns), lhs)
        return ns.HashJoin(getattr(ns.JoinType, jt), ["fk"], ["pk"], lhs,
                           ns.ScanTable(d), ns.KeyUniqueness.NOT_UNIQUE,
                           lhs_projector=ns.Projector.named("v"),
                           rhs_projector=ns.Projector.named("w"),
                           out_capacity=cap)
    return make


def test_dup8_inner_matches_jax_and_numpy():
    f, d, fact, dim = _dup8_data()
    kernels.reset_launches()
    rows = _same_rows(_dup8_join("INNER", False, 4096 * 8), f, d)
    assert set(kernels.launches.values()) == {0}  # CPU: plain versions only
    assert len(rows) == 4096 * 8
    # (lhs row, rhs original order)
    want_w = dim["w"].reshape(-1, 8)[fact["fk"]].ravel()
    assert [r[1] for r in rows] == want_w.tolist()
    assert [r[0] for r in rows] == np.repeat(fact["v"], 8).tolist()


def test_dup8_left_outer_under_filter_half_missing():
    f, d, fact, dim = _dup8_data(miss=2)
    rows = _same_rows(_dup8_join("LEFT_OUTER", True, 4096 * 8), f, d)
    keep = fact["v"] > 0.5
    hit = fact["fk"][keep] < 128
    assert len(rows) == int(8 * hit.sum() + (~hit).sum())
    assert sum(r[1] is None for r in rows) == int((~hit).sum()) > 0


@pytest.mark.parametrize("jt", ["INNER", "LEFT_OUTER"])
def test_not_unique_int64_keys_nullable_payloads(jt):
    """INT64 keys with NULLs on both sides, nullable 8-, 4- and 1-byte lhs
    payloads through the compaction and spread lanes, a nullable rhs."""
    rng = np.random.default_rng(3)
    n, m = 300, 90

    def nulls(vals, p):
        return [None if rng.random() < p else v.item() for v in vals]

    lhs = _both((("k", "INT64", True), ("x", "DOUBLE", True),
                 ("i", "INT32", True), ("b", "BOOL", True)),
                {"k": nulls(rng.integers(-5, 25, n) + (1 << 40), 0.1),
                 "x": nulls(rng.standard_normal(n), 0.2),
                 "i": nulls(rng.integers(-9, 9, n), 0.2),
                 "b": nulls(rng.random(n) < 0.5, 0.2)})
    rhs = _both((("k2", "INT64", True), ("y", "FLOAT", True)),
                {"k2": nulls(rng.integers(0, 20, m) + (1 << 40), 0.1),
                 "y": nulls(rng.standard_normal(m).astype(np.float32), 0.3)})
    rows = _same_rows(
        lambda ns, l, r: ns.HashJoin(getattr(ns.JoinType, jt), ["k"], ["k2"],
                                     ns.ScanTable(l), ns.ScanTable(r),
                                     out_capacity=4096), lhs, rhs)
    assert len(rows) > n // 2


def test_default_uniqueness_inner_join():
    """A plain HashJoin(INNER, ...) is NOT_UNIQUE, over the headline's
    tables: it expands through the CSR probe with capacity lhs + rhs."""
    fact, dim = headline_data(2048, 256)
    rows = _same_rows(
        lambda ns, f, d: ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"],
                                     ns.Filter(predicate(ns), ns.ScanTable(f)),
                                     ns.ScanTable(d)),
        _both(FACT_SCHEMA, fact), _both(DIM_SCHEMA, dim))
    assert len(rows) == int((fact["v"] > 0.5).sum())


@pytest.mark.parametrize("permute", [False, True], ids=["row_id", "fat_lut"])
@pytest.mark.parametrize("filtered", [False, True],
                         ids=["zero_copy", "fused_filter"])
def test_left_outer_unique_probes(permute, filtered):
    """LEFT_OUTER UNIQUE through the row-id and fat-LUT probes, zero-copy
    at lhs capacity or compacted under a fused Filter."""
    fact, dim = headline_data(4096, 512, permute=permute)
    fact["fk"][::3] += 512  # a third of the rows miss
    f, d = _both(FACT_SCHEMA, fact), _both(DIM_SCHEMA, dim)
    assert ("pk" in d[1].rowid) == (not permute)

    def make(ns, f, d):
        lhs = ns.ScanTable(f)
        if filtered:
            lhs = ns.Filter(predicate(ns), lhs)
        return ns.HashJoin(ns.JoinType.LEFT_OUTER, ["fk"], ["pk"], lhs,
                           ns.ScanTable(d), ns.KeyUniqueness.UNIQUE)

    rows = _same_rows(make, f, d)
    assert sum(r[3] is None for r in rows) > 0


def _with_h(fact, rng):
    return dict(fact, h=rng.integers(0, 16, len(fact["fk"])).astype(np.int32))


@pytest.mark.parametrize("permute", [False, True], ids=["row_id", "fat_lut"])
def test_left_outer_unique_masked_under_group_aggregate(permute):
    """The aggregate binds the LEFT_OUTER UNIQUE join masked with the lhs
    keep mask: unmatched rows count, their NULL g does not."""
    fact, dim = headline_data(4096, 512, permute=permute)
    fact["fk"][::2] += 512
    fact = _with_h(fact, np.random.default_rng(1))
    fs = FACT_SCHEMA + (("h", "INT32", False),)
    f, d = _both(fs, fact), _both(DIM_SCHEMA, dim)

    def make(ns, f, d):
        A = ns.Aggregation
        return ns.GroupAggregate(["h"], [
            ns.AggSpec(A.COUNT, None, "c"), ns.AggSpec(A.COUNT, "g", "cg"),
            ns.AggSpec(A.SUM, "g", "sg"), ns.AggSpec(A.SUM, "v", "sv")],
            ns.HashJoin(ns.JoinType.LEFT_OUTER, ["fk"], ["pk"],
                        ns.Filter(predicate(ns), ns.ScanTable(f)),
                        ns.ScanTable(d), ns.KeyUniqueness.UNIQUE))

    want = J.execute(make(J, f[0], d[0]))
    got = T.execute(make(T, f[1], d[1]))
    assert_grouped_equal(got, want, "h", {"sv"}, rtol=1e-5)
    c, cg = [(r[1], r[2]) for r in got.to_pylist()][0]
    assert c > cg > 0


def test_left_outer_unique_masked_under_sort():
    fact, dim = headline_data(4096, 512)
    fact["fk"][::2] += 512
    f, d = _both(FACT_SCHEMA, fact), _both(DIM_SCHEMA, dim)
    rows = _same_rows(
        lambda ns, f, d: ns.Sort(
            [ns.SortKey("g"), ns.SortKey("v", ascending=False)],
            ns.HashJoin(ns.JoinType.LEFT_OUTER, ["fk"], ["pk"],
                        ns.Filter(predicate(ns), ns.ScanTable(f)),
                        ns.ScanTable(d), ns.KeyUniqueness.UNIQUE)), f, d)
    assert len(rows) == int((fact["v"] > 0.5).sum())


def test_not_unique_join_under_group_aggregate_binds_unmasked():
    f, d, fact, dim = _dup8_data(2048, 512)

    def make(ns, f, d):
        return ns.GroupAggregate(
            ["w"], [ns.AggSpec(ns.Aggregation.SUM, "v", "sv"),
                    ns.AggSpec(ns.Aggregation.COUNT, None, "c")],
            _dup8_join("INNER", True, 2048 * 8)(ns, f, d))

    with pytest.raises(T.SchemaError, match="UNIQUE"):
        _dup8_join("INNER", False, 16)(T, f[1], d[1]).bind(
            T.BindContext(), _masked=True)
    got = T.execute(make(T, f[1], d[1]))
    jplan = make(J, f[0], d[0])
    jplan._pushdown_disabled = True  # the binding the port has
    assert_grouped_equal(got, J.execute(jplan), "w", {"sv"}, rtol=1e-5)
    assert sum(r[2] for r in got.to_pylist()) == 8 * int(
        (fact["v"] > 0.5).sum())


@pytest.mark.parametrize("jt", ["INNER", "LEFT_OUTER"])
def test_unique_fat_lut_with_duplicate_rhs_keys_takes_the_last_row(jt):
    """A UNIQUE rhs that breaks its promise (each key on two or three
    rows): the fat-LUT probe gives a probe row the value and the validity
    of the LAST rhs row holding its key, as the JAX package's marker sort
    does, and numpy agrees."""
    rng = np.random.default_rng(33)
    m, keys = 700, 300
    pk = np.concatenate([rng.permutation(keys), rng.permutation(keys),
                         rng.integers(0, keys, m - 2 * keys)])
    pk = pk[rng.permutation(m)].astype(np.int32)
    r = rng.integers(-50, 50, m)
    r_valid = rng.random(m) < 0.7
    dim = {"pk": pk.tolist(),
           "r": [int(x) if ok else None for x, ok in zip(r, r_valid)]}
    fact = {"fk": rng.integers(0, keys + 30, 2000).astype(np.int32),
            "v": rng.random(2000, dtype=np.float32)}
    f = _both(FACT_SCHEMA, fact)
    d = _both((("pk", "INT32", False), ("r", "INT64", True)), dim)
    assert "pk" not in d[1].rowid

    def make(ns, f, d):
        return ns.HashJoin(getattr(ns.JoinType, jt), ["fk"], ["pk"],
                           ns.ScanTable(f), ns.ScanTable(d),
                           ns.KeyUniqueness.UNIQUE,
                           rhs_projector=ns.Projector.named("r"))

    rows = _same_rows(make, f, d)
    last = {}
    for i, key in enumerate(pk.tolist()):
        last[key] = i
    want = []
    for fk, v in zip(fact["fk"].tolist(), fact["v"].tolist()):
        if fk in last:
            i = last[fk]
            want.append((fk, v, int(r[i]) if r_valid[i] else None))
        elif jt == "LEFT_OUTER":
            want.append((fk, v, None))
    assert rows == want
    assert any(x[2] is None for x in rows) and any(x[2] is not None
                                                   for x in rows)
