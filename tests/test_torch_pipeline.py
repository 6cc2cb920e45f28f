"""The port's slice against the JAX package, both on the CPU, at the entry
shape (8192 fact x 1024 dim rows): the same numpy inputs, the same plans
built by one function from either package."""
import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu_torch.ops.base import compile_plan as t_compile_plan
from supersonic_tpu_torch.ops.base import raise_flags

from torch_parity import (DIM_SCHEMA, FACT_SCHEMA, assert_grouped_equal,
                          headline_aggregate, headline_data, headline_join,
                          headline_plan, jax_raised, jax_table, predicate,
                          schema, torch_raised, torch_table)

torch.set_num_threads(1)

FACT, DIM = 8192, 1024


def _tables(fact, dim):
    return ((jax_table(J, FACT_SCHEMA, fact), jax_table(J, DIM_SCHEMA, dim)),
            (torch_table(T, FACT_SCHEMA, fact),
             torch_table(T, DIM_SCHEMA, dim)))


@pytest.mark.parametrize("projectors", [True, False],
                         ids=["bench_plan", "graft_entry_plan"])
@pytest.mark.parametrize("jax_binding", ["pushdown", "direct"])
def test_headline_matches_jax(projectors, jax_binding):
    fact, dim = headline_data(FACT, DIM)
    (jf, jd), (tf, td) = _tables(fact, dim)
    jplan = headline_plan(J, jf, jd, projectors)
    if jax_binding == "direct":
        setattr(jplan.child, "_pushdown_disabled", True)
    got = T.execute(headline_plan(T, tf, td, projectors))
    want = J.execute(jplan)
    assert_grouped_equal(got, want, "g", {"sv"}, rtol=1e-5)
    sv = [r[1] for r in got.to_pylist()]
    assert all(a >= b for a, b in zip(sv, sv[1:]))
    assert [a.type.value for a in got.schema] == \
        [a.type.value for a in want.schema]


@pytest.mark.parametrize("jax_binding", ["pushdown", "direct"])
def test_headline_aggregate_insertion_order(jax_binding):
    """Without the Sort, groups come out in first-occurrence order."""
    fact, dim = headline_data(FACT, DIM, groups=40, seed=5)
    (jf, jd), (tf, td) = _tables(fact, dim)
    jplan = headline_aggregate(J, jf, jd, groups=40)
    if jax_binding == "direct":
        setattr(jplan, "_pushdown_disabled", True)
    got = T.execute(headline_aggregate(T, tf, td, groups=40)).to_pylist()
    want = J.execute(jplan).to_pylist()
    assert [(g, c) for g, _, c in got] == [(g, c) for g, _, c in want]
    np.testing.assert_allclose([s for _, s, _ in got],
                               [s for _, s, _ in want], rtol=1e-5)


def test_unfused_filter_matches_jax():
    fact, dim = headline_data(FACT, DIM)
    (jf, _), (tf, _) = _tables(fact, dim)
    got = T.execute(T.Filter(predicate(T), T.ScanTable(tf)))
    want = J.execute(J.Filter(predicate(J), J.ScanTable(jf)))
    assert int(got.num_rows) == int(want.num_rows) > 0
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("projectors", [True, False])
def test_unmasked_join_over_permuted_key_matches_jax(projectors):
    """A permuted primary key takes the fat-LUT probe; unmasked, the
    matched rows are compacted."""
    fact, dim = headline_data(FACT, DIM, permute=True)
    (jf, jd), (tf, td) = _tables(fact, dim)
    assert "pk" not in tf.rowid and T.ScanTable(td).bind(
        T.BindContext()).stats["pk"] == (0, DIM - 1)
    got = T.execute(headline_join(T, tf, td, projectors))
    want = J.execute(headline_join(J, jf, jd, projectors))
    assert int(got.num_rows) == int(want.num_rows) > 0
    assert got.to_pylist() == want.to_pylist()


def test_row_id_join_with_out_of_range_keys():
    fact, dim = headline_data(FACT, DIM)
    fact["fk"][::7] += DIM  # no match
    fact["fk"][::11] -= DIM  # no match
    (jf, jd), (tf, td) = _tables(fact, dim)
    got = T.execute(headline_join(T, tf, td, False))
    want = J.execute(headline_join(J, jf, jd, False))
    assert got.to_pylist() == want.to_pylist()


def test_result_overflow_raises_like_jax():
    fact, dim = headline_data(FACT, DIM)
    (jf, jd), (tf, td) = _tables(fact, dim)
    jplan = headline_plan(J, jf, jd, groups=10)
    setattr(jplan.child, "_pushdown_disabled", True)
    with pytest.raises(J.exprs.EvaluationError,
                       match="aggregate result overflow"):
        J.execute(jplan)
    with pytest.raises(T.EvaluationError, match="aggregate result overflow"):
        T.execute(headline_plan(T, tf, td, groups=10))


def test_stale_statistics_raise_the_same_guard_flags():
    fact, dim = headline_data(FACT, DIM)
    (jf, jd), (tf, td) = _tables(fact, dim)
    # re-run the headline on a dim whose groups exceed the planned domain
    # and whose pk is no longer the row position
    dim2 = {"pk": dim["pk"][::-1].copy(), "g": dim["g"] + 30}
    (jf2, jd2), (tf2, td2) = _tables(fact, dim2)
    jplan = headline_plan(J, jf, jd)
    setattr(jplan.child, "_pushdown_disabled", True)
    want = jax_raised(jplan, [jf2, jd2])
    got = torch_raised(headline_plan(T, tf, td), [tf2, td2])
    assert got == want == {
        "aggregate key exceeds planned dense domain",
        "join rhs key is not the planned row-id sequence"}
    # fat-LUT join re-run on build keys past the planned range
    fact_p, dim_p = headline_data(FACT, DIM, permute=True)
    (jf, jd), (tf, td) = _tables(fact_p, dim_p)
    dim_p2 = {"pk": dim_p["pk"] + 5, "g": dim_p["g"]}
    (_, jd2), (_, td2) = _tables(fact_p, dim_p2)
    want = jax_raised(headline_join(J, jf, jd, True), [jf, jd2])
    got = torch_raised(headline_join(T, tf, td, True), [tf, td2])
    assert got == want == {"join build keys exceed planned dense range"}
    _, flags, names = t_compile_plan(headline_join(T, tf, td, True))[0](
        [tf, td2])
    with pytest.raises(T.EvaluationError, match="dense range"):
        raise_flags(flags, names)


NULL_SCHEMA = (("k", "INT32", False), ("a", "INT32", True),
               ("x", "DOUBLE", True), ("f", "FLOAT", True))


def _null_data(n=3000, seed=11):
    rng = np.random.default_rng(seed)
    data = {"k": rng.integers(-20, 20, n).astype(np.int32)}
    for name, make in (("a", lambda: rng.integers(-5, 5, n)),
                       ("x", lambda: rng.integers(-3, 3, n) / 2.0),
                       ("f", lambda: rng.standard_normal(n))):
        vals = make()
        data[name] = [None if rng.random() < 0.2 else v.item() for v in vals]
    return data


@pytest.mark.parametrize("keys", [
    [("a", True), ("x", False)],
    [("x", True), ("k", False), ("a", True)],
    [("f", False)],
])
def test_sort_nulls_and_stability_match_jax(keys):
    data = _null_data()
    jt = J.Table.from_data(schema(J, NULL_SCHEMA), data)
    tt = T.Table.from_data(schema(T, NULL_SCHEMA), data, device="cpu")
    order = [(n, asc) for n, asc in keys]
    got = T.execute(T.Sort([T.SortKey(n, a) for n, a in order],
                           T.ScanTable(tt))).to_pylist()
    want = J.execute(J.Sort([J.SortKey(n, a) for n, a in order],
                            J.ScanTable(jt))).to_pylist()
    assert got == want


def test_dense_aggregate_modes_match_jax():
    """Every dense aggregation, nullable inputs, insertion order, under a
    fused filter."""
    data = _null_data(seed=4)
    jt = J.Table.from_data(schema(J, NULL_SCHEMA), data)
    tt = T.Table.from_data(schema(T, NULL_SCHEMA), data, device="cpu")

    def plan(ns, t):
        A = ns.Aggregation
        return ns.GroupAggregate(["k"], [
            ns.AggSpec(A.SUM, "a", "sa"), ns.AggSpec(A.SUM, "f", "sf"),
            ns.AggSpec(A.MIN, "a", "mina"), ns.AggSpec(A.MAX, "f", "maxf"),
            ns.AggSpec(A.COUNT, "a", "ca"), ns.AggSpec(A.COUNT, None, "c"),
            ns.AggSpec(A.FIRST, "a", "fa"), ns.AggSpec(A.LAST, "f", "lf")],
            ns.Filter(ns.col("k") < ns.Const(15), ns.ScanTable(t)))

    got = T.execute(plan(T, tt)).to_pylist()
    want = J.execute(plan(J, jt)).to_pylist()
    assert len(got) == len(want) == 35
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2:4] == w[2:4] and g[5:8] == w[5:8], (g, w)
        for a, b in ((g[1], w[1]), (g[4], w[4]), (g[8], w[8])):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=1e-5)


def _signed_zeros(rng, x):
    """f32 x with its zeros' signs set at random, by their bits."""
    bits = x.view(np.int32).copy()
    zero = (bits & 0x7FFFFFFF) == 0
    bits[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -2 ** 31, 0)
    return bits.view(np.float32)


def test_dense_aggregate_float_nans_and_signed_zeros_match_jax():
    """MIN and MAX of a nullable FLOAT column holding NaNs of both signs
    (set by their bits) and +-0 match the JAX package: NaN for every group
    holding one (compared by isnan), every other group bit for bit, -0.0
    counting as +0.0.  SUM over +-0 matches it within rtol.  SUM over the
    NaN column gives NaN to exactly the groups holding one (numpy): the JAX
    kernel adds f32 sums as one-hot MXU dots, where a NaN row times 0 makes
    every group NaN."""
    rng = np.random.default_rng(6)
    n = 3000
    k = rng.integers(-20, 20, n).astype(np.int32)
    base = (np.round(rng.standard_normal(n) * 2) / 2).astype(np.float32)
    # groups of even k hold values <= 0 and odd ones >= 0, so +-0 decides
    # many a max and a min
    z = _signed_zeros(rng, np.where(k % 2 == 0, -np.abs(base),
                                    np.abs(base)).astype(np.float32))
    f = z.copy()
    nan_bits = f.view(np.int32)
    nan_bits[rng.choice(n, 5, replace=False)] = 0x7FC00000   # +NaN
    nan_bits[rng.choice(n, 5, replace=False)] = -0x00400000  # -NaN
    f_valid = rng.random(n) < 0.9
    cols = (("k", "INT32", False), ("f", "FLOAT", True), ("z", "FLOAT", False))
    jt = J.Table.from_arrays(schema(J, cols), {"k": k, "f": f, "z": z},
                             {"f": f_valid}, n)
    tt = T.Table.from_numpy(schema(T, cols),
                            {"k": k, "f": (f, f_valid), "z": z},
                            device="cpu")

    def plan(ns, t):
        A = ns.Aggregation
        return ns.GroupAggregate(["k"], [
            ns.AggSpec(A.MIN, "f", "minf"), ns.AggSpec(A.MAX, "f", "maxf"),
            ns.AggSpec(A.SUM, "z", "sz"), ns.AggSpec(A.SUM, "f", "sf"),
            ns.AggSpec(A.COUNT, "f", "cf")], ns.ScanTable(t))

    got = T.execute(plan(T, tt)).to_pylist()
    want = J.execute(plan(J, jt)).to_pylist()
    assert [r[0] for r in got] == [r[0] for r in want] and len(got) == 40
    assert [r[5] for r in got] == [r[5] for r in want]
    for c in (1, 2):  # MIN, MAX
        a = np.array([r[c] for r in got], np.float32)
        b = np.array([r[c] for r in want], np.float32)
        assert np.array_equal(np.isnan(a), np.isnan(b)) and np.isnan(a).any()
        np.testing.assert_array_equal(a[~np.isnan(a)].view(np.int32),
                                      b[~np.isnan(b)].view(np.int32))
    np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want],
                               rtol=1e-5)
    sums = {}
    for key, x, ok in zip(k, f, f_valid):
        if ok:
            sums[int(key)] = sums.get(int(key), 0.0) + float(x)
    sf = np.array([r[4] for r in got])
    want_sf = np.array([sums[r[0]] for r in got])
    assert np.array_equal(np.isnan(sf), np.isnan(want_sf))
    assert 0 < np.isnan(sf).sum() < len(got)
    np.testing.assert_allclose(sf[~np.isnan(sf)], want_sf[~np.isnan(sf)],
                               rtol=1e-5)
    assert all(np.isnan(r[4]) for r in want)  # the JAX kernel's one-hot dot


@pytest.mark.parametrize("make", [
    # dense LEFT_OUTER and NOT_UNIQUE joins are ported; without dense
    # lookups they need the merge probe, which is not
    lambda t, d: T.HashJoin(T.JoinType.LEFT_OUTER, ["fk"], ["pk"],
                            T.ScanTable(t), T.ScanTable(d),
                            T.KeyUniqueness.UNIQUE,
                            rhs_projector=T.Projector.named("g"),
                            allow_dense_lookup=False),
    lambda t, d: T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"],
                            T.ScanTable(t), T.ScanTable(d),
                            rhs_projector=T.Projector.named("g"),
                            allow_dense_lookup=False),
    # the sort path and the widened dense path are ported; their item 12
    # options (max_unique_keys_in_result, DISTINCT) are not
    lambda t, d: T.GroupAggregate(["pk"], [T.AggSpec(T.Aggregation.COUNT,
                                                     None, "c")],
                                  T.ScanTable(d), T.GroupAggregateOptions(
                                      max_unique_keys_in_result=100)),
    lambda t, d: T.GroupAggregate(["g"], [T.AggSpec(T.Aggregation.SUM, "v",
                                                    "s", T.DOUBLE,
                                                    distinct=True)],
                                  T.ScanTable(d)),
], ids=["left_outer", "not_unique", "non_dense_group_by", "sum_widening"])
def test_outside_the_slice_raises_not_implemented(make):
    fact, dim = headline_data(FACT, DIM)
    _, (tf, td) = _tables(fact, dim)
    td = T.Table.from_numpy(
        schema(T, DIM_SCHEMA + (("v", "FLOAT", False),)),
        dict(dim, pk=dim["pk"] * 4, v=np.ones(DIM, np.float32)),
        device="cpu")  # pk spans 4093 slots: past the dense group-by's 2048
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.execute(make(tf, td))


def test_string_columns_are_not_ported():
    """STRING columns are ported now (dictionary codes, as in the JAX
    package); string constants and the other types of ROADMAP.md queue 1
    item 14 still raise."""
    t = T.Table.from_data(T.TupleSchema.of(("s", T.DataType.STRING)),
                          {"s": ["b", "a", None, "b"]}, device="cpu")
    j = J.Table.from_data(J.TupleSchema.of(("s", J.DataType.STRING)),
                          {"s": ["b", "a", None, "b"]})
    assert t.to_pylist() == j.to_pylist() == [("b",), ("a",), (None,),
                                              ("b",)]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.Table.from_data(T.TupleSchema.of(("d", T.DataType.DATE)),
                          {"d": [1]}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.execute(T.Filter(T.col("s") > T.Const("a", T.DataType.STRING),
                           T.ScanTable(t)))


def test_composite_keys_match_jax():
    """Two-key fat-LUT join (unmasked) and two-key dense group-by."""
    rng = np.random.default_rng(21)
    n, da, db = 4000, 12, 9
    ka, kb = np.divmod(rng.permutation(da * db), db)
    dim = {"ka": ka.astype(np.int32), "kb": kb.astype(np.int32),
           "g": rng.integers(0, 5, da * db).astype(np.int32)}
    fact = {"a": rng.integers(0, da + 2, n).astype(np.int32),  # some miss
            "b": rng.integers(0, db, n).astype(np.int32),
            "v": rng.random(n).astype(np.float32)}
    fs = (("a", "INT32", False), ("b", "INT32", False), ("v", "FLOAT", False))
    ds = (("ka", "INT32", False), ("kb", "INT32", False), ("g", "INT32", False))

    def join(ns, f, d):
        return ns.HashJoin(ns.JoinType.INNER, ["a", "b"], ["ka", "kb"],
                           ns.ScanTable(f), ns.ScanTable(d),
                           ns.KeyUniqueness.UNIQUE)

    def group(ns, f, d):
        return ns.GroupAggregate(
            ["g", "b"], [ns.AggSpec(ns.Aggregation.SUM, "v", "s"),
                         ns.AggSpec(ns.Aggregation.COUNT, None, "c")],
            join(ns, f, d))

    jf, jd = jax_table(J, fs, fact), jax_table(J, ds, dim)
    tf, td = torch_table(T, fs, fact), torch_table(T, ds, dim)
    assert T.execute(join(T, tf, td)).to_pylist() == \
        J.execute(join(J, jf, jd)).to_pylist()
    jplan = group(J, jf, jd)
    setattr(jplan, "_pushdown_disabled", True)
    got = T.execute(group(T, tf, td)).to_pylist()
    want = J.execute(jplan).to_pylist()
    assert [(g, b, c) for g, b, _, c in got] == \
        [(g, b, c) for g, b, _, c in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-5)


def test_dense_aggregate_over_more_keys_than_the_kernel_takes():
    """Five dense group keys (the kernel codes up to four): the aggregate
    passes one composite slot lane instead, and the rows, their order and
    the stale-statistics flag match the JAX package."""
    rng = np.random.default_rng(8)
    n = 900
    names = ["a", "b", "c", "d", "e"]
    data = {nm: rng.integers(0, 3, n).astype(np.int32) for nm in names}
    data["v"] = rng.integers(-9, 9, n).astype(np.int32)
    cols = tuple((nm, "INT32", False) for nm in names) + (
        ("v", "INT32", False),)

    def plan(ns, t):
        A = ns.Aggregation
        return ns.GroupAggregate(names, [ns.AggSpec(A.SUM, "v", "s"),
                                         ns.AggSpec(A.MIN, "v", "m"),
                                         ns.AggSpec(A.COUNT, None, "n")],
                                 ns.ScanTable(t))

    jt, tt = jax_table(J, cols, data), torch_table(T, cols, data)
    got = T.execute(plan(T, tt)).to_pylist()
    assert got == J.execute(plan(J, jt)).to_pylist() and len(got) > 200
    stale = dict(data, e=data["e"] + 2)
    (jt2, tt2) = jax_table(J, cols, stale), torch_table(T, cols, stale)
    assert torch_raised(plan(T, tt), [tt2]) == jax_raised(
        plan(J, jt), [jt2]) == {"aggregate key exceeds planned dense domain"}


def test_from_data_takes_the_jax_argument_order():
    """from_data(schema, data, capacity, dicts) means the same in both
    packages; the device is a keyword that defaults to the card."""
    import inspect

    s = schema(T, DIM_SCHEMA)
    data = {"pk": [1, 2, 3], "g": [4, 5, 6]}
    t = T.Table.from_data(s, data, 16, device="cpu")
    j = J.Table.from_data(schema(J, DIM_SCHEMA), data, 16)
    assert t.capacity == j.capacity == 16 and t.device.type == "cpu"
    assert t.to_pylist() == j.to_pylist()
    for build in (T.Table.from_data, T.Table.from_numpy):
        p = inspect.signature(build).parameters
        assert list(p)[:4] == ["schema", "data" if build is T.Table.from_data
                               else "arrays", "capacity", "dicts"]
        assert p["device"].kind is inspect.Parameter.KEYWORD_ONLY
        assert p["device"].default == "cuda"
    with pytest.raises(TypeError):  # a fifth positional is not a device
        T.Table.from_data(s, data, 16, None, "cpu")
