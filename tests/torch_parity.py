"""Shared helpers of the PyTorch-port parity tests (not collected).

The same numpy inputs, made from a seed, go through the JAX package and
the port; the plan-building functions take either package as a namespace.
"""
import numpy as np

FACT_SCHEMA = (("fk", "INT32", False), ("v", "FLOAT", False))
DIM_SCHEMA = (("pk", "INT32", False), ("g", "INT32", False))


def schema(ns, cols, enums=None):
    """``cols``: (name, type name, nullable); ``enums[name]`` names the
    values of an ENUM column."""
    enums = enums or {}
    return ns.TupleSchema([
        ns.Attribute(n, getattr(ns.DataType, t), nullable,
                     ns.EnumDefinition(enums[n]) if n in enums else None)
        for n, t, nullable in cols])


def headline_data(fact_rows, dim_rows, groups=64, seed=42, permute=False):
    """bench.py's data: fact (fk, v) and dim (pk, g); ``permute`` shuffles
    pk so the join cannot take the row-id probe."""
    rng = np.random.default_rng(seed)
    fact = {"fk": rng.integers(0, dim_rows, fact_rows).astype(np.int32),
            "v": rng.random(fact_rows, dtype=np.float32)}
    pk = np.arange(dim_rows, dtype=np.int32)
    if permute:
        pk = rng.permutation(pk).astype(np.int32)
    dim = {"pk": pk,
           "g": rng.integers(0, groups, dim_rows).astype(np.int32)}
    return fact, dim


def jax_table(ns, cols, data):
    return ns.Table.from_data(schema(ns, cols), data)


def torch_table(ns, cols, data, device="cpu"):
    return ns.Table.from_data(schema(ns, cols), data, device=device)


def predicate(ns):
    return ns.col("v") > ns.Const(0.5, ns.DataType.FLOAT)


def headline_join(ns, fact, dim, projectors):
    kw = {}
    if projectors:
        kw = dict(lhs_projector=ns.Projector.named("v"),
                  rhs_projector=ns.Projector.named("g"))
    return ns.HashJoin(ns.JoinType.INNER, ["fk"], ["pk"],
                       ns.Filter(predicate(ns), ns.ScanTable(fact)),
                       ns.ScanTable(dim), ns.KeyUniqueness.UNIQUE, **kw)


def headline_aggregate(ns, fact, dim, projectors=True, groups=64):
    return ns.GroupAggregate(
        ["g"],
        [ns.AggSpec(ns.Aggregation.SUM, "v", "sv"),
         ns.AggSpec(ns.Aggregation.COUNT, None, "c")],
        headline_join(ns, fact, dim, projectors),
        ns.GroupAggregateOptions(estimated_result_row_count=groups))


def headline_plan(ns, fact, dim, projectors=True, groups=64):
    """bench.py:73-86 (projectors=True) and __graft_entry__.py:34-45
    (projectors=False): filter -> join -> group-by -> sort(sv DESC)."""
    return ns.Sort([ns.SortKey("sv", ascending=False)],
                   headline_aggregate(ns, fact, dim, projectors, groups))


def bit_rows(rows):
    """Rows with each float as its repr, so NaN equals NaN and -0.0 differs
    from 0.0."""
    return [tuple(repr(x) if isinstance(x, float) else x for x in r)
            for r in rows]


def same_rows(J, T, make, *pairs):
    """Execute make(ns, *tables) in both packages over (JAX table, port
    table) pairs: equal schemas, and rows equal in order with floats bit
    for bit.  Returns the port's rows."""
    want = J.execute(make(J, *[p[0] for p in pairs]))
    got = T.execute(make(T, *[p[1] for p in pairs]))
    assert [(a.name, a.type.value, a.nullable) for a in got.schema] == \
        [(a.name, a.type.value, a.nullable) for a in want.schema]
    rows = got.to_pylist()
    assert bit_rows(rows) == bit_rows(want.to_pylist())
    return rows


def rows_by_key(table, key):
    """{key value: row tuple} of a result table's live rows."""
    names = list(table.schema.names())
    k = names.index(key)
    return {r[k]: r for r in table.to_pylist()}


def assert_grouped_equal(got, want, key, float_cols, rtol):
    """Same groups; every non-float column exact, float columns within
    rtol."""
    g, w = rows_by_key(got, key), rows_by_key(want, key)
    assert sorted(g) == sorted(w)
    names = list(want.schema.names())
    assert list(got.schema.names()) == names
    for k in w:
        for name, a, b in zip(names, g[k], w[k]):
            if name in float_cols:
                np.testing.assert_allclose(a, b, rtol=rtol)
            else:
                assert a == b, (k, name, a, b)


def jax_raised(plan, leaves):
    """Flag names the JAX package raises for a compiled plan re-run on
    other leaves (as its execute() recovers them)."""
    from supersonic_tpu.ops.base import RunContext, compile_plan

    run, bound, _ = compile_plan(plan)
    _, flags = run(leaves)
    ctx = RunContext(list(leaves))
    bound.run(ctx)
    return {n for (n, _), f in zip(ctx.error_flags, np.asarray(flags)) if f}


def torch_raised(plan, leaves):
    """Flag names the port raises for a bound plan re-run on other leaves."""
    from supersonic_tpu_torch.ops.base import compile_plan

    run, _, _ = compile_plan(plan)
    _, flags, names = run(leaves)
    return {n for n, f in zip(names, flags.tolist()) if f}


def tables(J, T, cols, arrays, dicts=None, capacity=None, enums=None):
    """(JAX table, port table on the CPU) of the same numpy columns:
    ``arrays[name]`` is a value array or a ``(values, valid)`` pair;
    a STRING/BINARY column gives int32 codes and ``dicts[name]`` the sorted
    tuple of its values, or a (JAX, port) pair of Dictionary objects that
    tables share; ``enums[name]`` names an ENUM column's values."""
    values, valids = {}, {}
    for name, raw in arrays.items():
        values[name], valids[name] = (raw if isinstance(raw, tuple)
                                      else (raw, None))
    n = len(next(iter(values.values())))
    jd, td = {}, {}
    for k, v in (dicts or {}).items():
        shared = isinstance(v[0], J.Dictionary)
        jd[k] = v[0] if shared else J.Dictionary(tuple(v))
        td[k] = v[1] if shared else T.Dictionary(tuple(v))
    jt = J.Table.from_arrays(schema(J, cols, enums), values, valids, n, jd,
                             capacity)
    tt = T.Table.from_numpy(schema(T, cols, enums), arrays, capacity, td,
                            device="cpu")
    return jt, tt


def computed_plan(ns, t):
    """Compute, arithmetic and logic over the columns a (INT32, nullable),
    b (INT64), c (INT32), x (FLOAT) and y (DOUBLE, nullable), then a Filter
    on ``(a > 3) & ~(y < 0)``: the same plan in either package."""
    col, C, D = ns.col, ns.Const, ns.DataType
    exprs = [col("a"), col("y"),
             (col("a") * 3 - col("b")).as_("ab"),
             (col("x") + col("a")).as_("xa"),
             (col("y") / (col("c") * col("c") + C(1))).as_("yc"),
             ns.CppDivideNulling(col("b"), col("a")).as_("ba"),
             ns.ModulusNulling(col("a"), C(7)).as_("am"),
             (-col("y")).as_("ny"),
             ns.IfNull(col("y"), C(0.5, D.DOUBLE)).as_("y0"),
             ns.IsNull(col("y")).as_("yn"),
             ns.Sequence().as_("seq")]
    return ns.Filter((col("a") > C(3)) & ~(col("y") < C(0.0, D.DOUBLE)),
                     ns.Compute(exprs, ns.ScanTable(t)))
