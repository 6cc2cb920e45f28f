"""The port's secondary operators against the JAX package, both on the
CPU, mirroring tests/test_misc_ops.py and tests/test_merge_rowid.py:
Limit, Coalesce, Generate, RowidMergeJoin and its integrity flag,
ForeignFilter, SharedOperation, Spy, TakeOwnership, format_table,
group_concat, to_string, and MergeUnionAll over more compare words than
the merge kernel takes.  The same numpy columns, made from a seed, go
through the same plan built from either package; rows must be equal."""
import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T

from torch_parity import bit_rows, same_rows, tables

torch.set_num_threads(1)


def _data(n=50, seed=5):
    rng = np.random.default_rng(seed)
    cols = (("k", "INT64", False), ("s", "STRING", True),
            ("v", "DOUBLE", True), ("i", "INT32", False))
    return tables(J, T, cols, {
        "k": rng.integers(0, 4, n),
        "s": (rng.integers(0, 3, n).astype(np.int32), rng.random(n) > 0.2),
        "v": (rng.standard_normal(n), rng.random(n) > 0.2),
        "i": rng.integers(-9, 9, n).astype(np.int32)},
        {"s": ("ab1", "cd2", "ef3")}, capacity=64)


DATA = _data()


@pytest.mark.parametrize("offset,limit", [(0, 10), (7, 20), (45, 10),
                                          (60, 5), (0, 0), (3, 100)])
def test_limit_matches_jax(offset, limit):
    """An offset and row-count window, ends and empty windows included;
    over a Sort, a top-N."""
    rows = same_rows(J, T, lambda ns, t: ns.Limit(offset, limit,
                                                  ns.ScanTable(t)), DATA)
    assert len(rows) == max(0, min(limit, 50 - offset))
    same_rows(J, T, lambda ns, t: ns.Limit(offset, limit, ns.Sort(
        [ns.SortKey("v", ascending=False)], ns.ScanTable(t))), DATA)


def test_limit_over_a_filter_and_no_columns():
    """A device row count (under a Filter) and a zero-column child."""
    same_rows(J, T, lambda ns, t: ns.Limit(2, 9, ns.Filter(
        ns.col("i") > ns.Const(0, ns.DataType.INT32), ns.ScanTable(t))), DATA)
    for ns, kw in ((J, {}), (T, {"device": "cpu"})):
        out = ns.execute(ns.Limit(3, 4, ns.Generate(5, **kw)))
        assert int(out.num_rows) == 2 and out.capacity == 4


def test_coalesce_matches_jax():
    """Schemas concatenated; a shorter child is padded and the row count
    is the least of the children's."""
    short = tables(J, T, (("w", "INT64", True),),
                   {"w": (np.arange(30), np.arange(30) % 3 > 0)})
    same_rows(J, T, lambda ns, a, b: ns.Coalesce(
        ns.ScanTable(a), ns.ScanTable(b)), DATA, short)
    same_rows(J, T, lambda ns, a, b: ns.Coalesce(
        ns.ScanTable(b), ns.Filter(ns.col("i") > ns.Const(0, ns.DataType.INT32),
                                   ns.ScanTable(a))), DATA, short)
    for ns, t in zip((J, T), DATA):
        with pytest.raises(ns.SchemaError):
            ns.execute(ns.Coalesce(ns.ScanTable(t), ns.ScanTable(t)))


def test_generate_and_sequence_match_jax():
    rows = {}
    for ns, kw in ((J, {}), (T, {"device": "cpu"})):
        out = ns.execute(ns.Compute([ns.Sequence().as_("q")],
                                    ns.Generate(7, **kw)))
        rows[ns] = out.to_pylist()
    assert rows[J] == rows[T] == [(q,) for q in range(7)]


def _rowid_tables(bad=False):
    rng = np.random.default_rng(11)
    fk = rng.integers(0, 20, 60)
    if bad:
        fk[17] = 20
    left = tables(J, T, (("fk", "INT64", False), ("lv", "INT32", True)),
                  {"fk": fk, "lv": (rng.integers(0, 9, 60).astype(np.int32),
                                    rng.random(60) > 0.3)})
    right = tables(J, T, (("name", "STRING", True), ("w", "DOUBLE", False)),
                   {"name": (rng.integers(0, 3, 20).astype(np.int32),
                             rng.random(20) > 0.2),
                    "w": rng.standard_normal(20)}, {"name": ("x", "y", "z")})
    return left, right


def _rowid_plan(ns, a, b):
    return ns.RowidMergeJoin(
        "fk", ns.ScanTable(a), ns.ScanTable(b),
        lhs_projector=ns.Projector([("fk", "L.fk"), ("lv", "L.lv")]),
        rhs_projector=ns.Projector([("name", "R.name"), ("w", "R.w")]))


def test_rowid_merge_join_matches_jax():
    left, right = _rowid_tables()
    rows = same_rows(J, T, _rowid_plan, left, right)
    assert len(rows) == 60


def test_rowid_merge_join_integrity_flag():
    """A fk past the right side's rows raises in both packages."""
    left, right = _rowid_tables(bad=True)
    with pytest.raises(J.EvaluationError, match="referential integrity"):
        J.execute(_rowid_plan(J, left[0], right[0]))
    with pytest.raises(T.EvaluationError, match="referential integrity"):
        T.execute(_rowid_plan(T, left[1], right[1]))
    s = T.TupleSchema.of(("fk", T.INT64, False))
    lhs = T.Table.from_data(s, {"fk": [-1]}, device="cpu")
    with pytest.raises(T.EvaluationError):
        T.execute(T.RowidMergeJoin("fk", T.ScanTable(lhs),
                                   T.ScanTable(right[1])))


@pytest.mark.parametrize("key_t", ["INT64", "INT32"])
def test_foreign_filter_matches_jax(key_t):
    """The lhs rows whose fk is in the ascending key column, fk rewritten
    to the key's row id; the rhs's padding rows match nothing."""
    rng = np.random.default_rng(12)
    keys = np.unique(rng.integers(0, 40, 25)).astype(getattr(np, key_t.lower()))
    lhs = tables(J, T, (("fk", "INT64", False), ("lv", "INT64", True)),
                 {"fk": np.sort(rng.integers(-2, 45, 70)),
                  "lv": (np.arange(70), np.arange(70) % 4 > 0)})
    rhs = tables(J, T, (("key", key_t, False),), {"key": keys},
                 capacity=len(keys) + 5)
    rows = same_rows(J, T, lambda ns, a, b: ns.ForeignFilter(
        "fk", "key", ns.ScanTable(a), ns.ScanTable(b)), lhs, rhs)
    assert 0 < len(rows) < 70


def test_foreign_filter_example():
    lhs = tables(J, T, (("fk", "INT64", False), ("lv", "INT64", False)),
                 {"fk": np.array([2, 5, 7, 9]), "lv": np.array([1, 2, 3, 4])})
    rhs = tables(J, T, (("key", "INT64", False),), {"key": np.array([2, 7, 8])})
    assert same_rows(J, T, lambda ns, a, b: ns.ForeignFilter(
        "fk", "key", ns.ScanTable(a), ns.ScanTable(b)), lhs, rhs) == \
        [(0, 1), (1, 3)]


def test_shared_operation_runs_once():
    """One subtree, two consumers, one run a RunContext."""
    runs = []

    class Counting(T.Operation):
        def __init__(self, child):
            self.child = child

        def bind(self, ctx):
            cb = self.child.bind(ctx)

            def fn(rctx):
                runs.append(1)
                return cb.run(rctx)
            return T.BoundOperation(cb.schema, cb.dicts, fn, cb.capacity)

    def make(ns, t, wrap=lambda c: c):
        shared = ns.SharedOperation(wrap(ns.Filter(
            ns.col("k") > ns.Const(0, ns.DataType.INT64), ns.ScanTable(t))))
        return ns.Coalesce(ns.Project(ns.Projector([("k", "k1")]), shared),
                           ns.Project(ns.Projector([("s", "s2")]), shared))

    same_rows(J, T, make, DATA)
    T.execute(make(T, DATA[1], Counting))
    assert runs == [1]


@pytest.mark.parametrize("check_errors", [True, False])
def test_spy_reports_rows_after_the_sync(check_errors):
    """Each Spy reports its node's row count, as the JAX package's does;
    the counts come back in the flags' one transfer."""
    seen = {J: [], T: []}

    def listener(ns):
        class L(ns.SpyListener):
            def on_result(self, name, num_rows):
                seen[ns].append((name, num_rows))
        return L()

    for ns, t in zip((J, T), DATA):
        plan = ns.Spy("outer", ns.Limit(0, 5, ns.Spy(
            "filter", ns.Filter(ns.col("i") > ns.Const(1, ns.DataType.INT32),
                                ns.ScanTable(t)), listener(ns))),
            listener(ns))
        ns.execute(plan, check_errors=check_errors)
    assert sorted(seen[T]) == sorted(seen[J])
    assert ("outer", 5) in seen[T]


def test_take_ownership_and_format_table():
    owned = object()
    for ns, t in zip((J, T), DATA):
        plan = ns.TakeOwnership(ns.ScanTable(t), owned)
        assert plan._owned == (owned,)
    texts = [ns.format_table(ns.execute(ns.TakeOwnership(ns.ScanTable(t))),
                             limit=limit)
             for limit in (5, 100) for ns, t in zip((J, T), DATA)]
    assert texts[0] == texts[1] and texts[2] == texts[3]
    assert "more rows" in texts[0] and "'ab1'" in texts[2]


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("route", ["native", "python"])
def test_group_concat_matches_jax(distinct, route, monkeypatch):
    """group_concat over a nullable key, STRING and DOUBLE inputs, groups
    in first-appearance order, through the C++ assembly and the Python
    loop."""
    from supersonic_tpu_torch import native

    if route == "python":
        monkeypatch.setattr(native, "concat_groups", lambda *a: None)
    for inp in ("s", "v"):
        want = J.group_concat(J.ScanTable(DATA[0]), ["k"], inp, "cs",
                              distinct=distinct)
        got = T.group_concat(T.ScanTable(DATA[1]), ["k"], inp, "cs",
                             distinct=distinct)
        assert got.to_pylist() == want.to_pylist()
        assert got.device == DATA[1].device


def test_to_string_matches_jax():
    for inp in ("k", "v", "s"):
        want = J.to_string(J.ScanTable(DATA[0]), inp, "str")
        got = T.to_string(T.ScanTable(DATA[1]), inp, "str")
        assert bit_rows(got.to_pylist()) == bit_rows(want.to_pylist())


def test_format_number_and_concat_columns_match_jax():
    """The host renderings of ops/host.py beside to_string."""
    from supersonic_tpu.ops import host as jh
    from supersonic_tpu_torch.ops import host as th

    for prec in (-1, 0, 3):
        want = jh.format_number(J.ScanTable(DATA[0]), "v", prec, "fv")
        got = th.format_number(T.ScanTable(DATA[1]), "v", prec, "fv")
        assert got.to_pylist() == want.to_pylist()
    want = jh.concat_columns(J.ScanTable(DATA[0]), ["s", "k", "v"], "cc",
                             "|")
    got = th.concat_columns(T.ScanTable(DATA[1]), ["s", "k", "v"], "cc", "|")
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("nkeys", [9, 17])
def test_merge_union_all_past_the_kernel_words_matches_jax(nkeys):
    """A merge order of more compare words than the merge kernel takes (9
    nullable keys are 18 words; 17 non-nullable INT64 keys, 17) is one
    stable sort of the concatenated children, ties in (child, row) order;
    children with their own dictionaries."""
    rng = np.random.default_rng(nkeys)
    nullable = nkeys == 9
    cols = tuple((f"c{j}", "INT64", nullable) for j in range(nkeys)) + (
        ("s", "STRING", True), ("row", "INT32", False))
    pairs = []
    for part, n in enumerate((30, 25, 20)):
        data = {f"c{j}": ((rng.integers(0, 2, n),
                           rng.random(n) > 0.2) if nullable
                          else rng.integers(0, 2, n)) for j in range(nkeys)}
        data["s"] = (rng.integers(0, 3, n).astype(np.int32),
                     rng.random(n) > 0.1)
        data["row"] = np.arange(n, dtype=np.int32) + 100 * part
        pairs.append(tables(J, T, cols, data,
                            {"s": tuple(f"w{part}{i}" for i in range(3))}))
    keys = [(f"c{j}", j % 2 == 0) for j in range(nkeys)] + [("s", True)]

    def make(ns, *ts):
        order = [ns.SortKey(n, ascending=a) for n, a in keys]
        return ns.MergeUnionAll(order, [ns.Sort(order, ns.ScanTable(t))
                                        for t in ts])

    rows = same_rows(J, T, make, *pairs)
    assert len(rows) == 75
