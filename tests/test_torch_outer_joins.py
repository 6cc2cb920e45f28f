"""The port's RIGHT_OUTER and FULL_OUTER joins against the JAX package, both
on the CPU, mirroring tests/test_outer_joins.py: the same plans over the
same tables give the same rows in the same order (UnionAll's order for
FULL_OUTER, the mirrored join's for RIGHT_OUTER), and the rows as a
multiset equal a row-wise Python oracle (NULL keys never match).  The lhs
keys are nullable, so the JAX package's distinct-key group-by takes its
sort path (no interpret-mode kernel)."""
import functools

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T

from test_outer_joins import _canon, _full_oracle, _right_oracle
from torch_parity import same_rows, schema

torch.set_num_threads(1)

_rows = functools.partial(same_rows, J, T)

L = (("k", "INT64", True), ("lv", "DOUBLE", False))
R = (("rk", "INT64", True), ("rv", "INT64", False))


def _both(cols, data, capacity=None):
    return (J.Table.from_data(schema(J, cols), data, capacity),
            T.Table.from_data(schema(T, cols), data, capacity,
                              device="cpu"))


def _outer(jt, uniq="NOT_UNIQUE", dense=True, lk=("k",), rk=("rk",),
           lhs=None, **kw):
    def make(ns, l, r):
        return ns.HashJoin(getattr(ns.JoinType, jt), list(lk), list(rk),
                           lhs(ns, l) if lhs else ns.ScanTable(l),
                           ns.ScanTable(r), getattr(ns.KeyUniqueness, uniq),
                           allow_dense_lookup=dense, **kw)
    return make


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("uniq", ["UNIQUE", "NOT_UNIQUE"])
def test_right_and_full_outer_differential(uniq, dense):
    """tests/test_outer_joins.py's differential case (its first seed),
    dense and through the merge probe."""
    rng = np.random.default_rng(0)
    nl, nr = 83, 41
    lk = [None if rng.random() < 0.15 else int(v)
          for v in rng.integers(0, 30, nl)]
    lv = [float(v) for v in rng.normal(size=nl)]
    if uniq == "UNIQUE":
        rk = [None if rng.random() < 0.1 else int(v)
              for v in rng.permutation(60)[:nr]]
    else:
        rk = [None if rng.random() < 0.1 else int(v)
              for v in rng.integers(0, 30, nr)]
    rv = [int(v) for v in rng.integers(0, 1000, nr)]
    l, r = _both(L, {"k": lk, "lv": lv}), _both(R, {"rk": rk, "rv": rv})
    lrows, rrows = list(zip(lk, lv)), list(zip(rk, rv))
    got = _rows(_outer("RIGHT_OUTER", uniq, dense), l, r)
    assert _canon(got) == _canon(_right_oracle(lrows, rrows, 0, 0))
    got = _rows(_outer("FULL_OUTER", uniq, dense), l, r)
    assert _canon(got) == _canon(_full_oracle(lrows, rrows, 0, 0))


@pytest.mark.parametrize("jt", ["RIGHT_OUTER", "FULL_OUTER"])
def test_outer_string_keys_and_projectors(jt):
    """STRING keys over separate dictionaries (the marker join dense over
    the dictionary), projectors picking and renaming columns, and rhs
    columns forced nullable."""
    lc = (("k", "STRING", True), ("lv", "INT64", False))
    rc = (("rk", "STRING", False), ("rv", "STRING", False))
    l = _both(lc, {"k": ["x", None, "y", "zz"], "lv": [1, 2, 3, 4]})
    r = _both(rc, {"rk": ["y", "w", "x"], "rv": ["Y", "W", "X"]})
    rows = _rows(_outer(jt, "UNIQUE"), l, r)
    assert len(rows[0]) == 4
    rows = _rows(lambda ns, a, b: _outer(
        jt, "UNIQUE", lhs_projector=ns.Projector([("lv", "LV")]),
        rhs_projector=ns.Projector.named("rv"))(ns, a, b), l, r)
    if jt == "FULL_OUTER":
        assert _canon(rows) == _canon([(1, "X"), (3, "Y"), (2, None),
                                       (4, None), (None, "W")])
    else:
        assert _canon(rows) == _canon([(1, "X"), (3, "Y"), (None, "W")])


def test_right_outer_with_fused_filter():
    """A Filter on RIGHT_OUTER's lhs knocks rows out before the join: the
    rhs row they would have matched surfaces unmatched."""
    lc = (("k", "INT64", False), ("lv", "INT64", False))
    rc = (("rk", "INT64", False), ("rv", "INT64", False))
    l = _both(lc, {"k": [1, 2, 3], "lv": [10, 20, 30]})
    r = _both(rc, {"rk": [2, 3, 4], "rv": [200, 300, 400]})
    for dense in (True, False):
        rows = _rows(_outer("RIGHT_OUTER", dense=dense,
                            lhs=lambda ns, t: ns.Filter(
                                ns.col("lv") < 25, ns.ScanTable(t))), l, r)
        assert _canon(rows) == _canon([(2, 20, 2, 200), (None, None, 3, 300),
                                       (None, None, 4, 400)])


def test_full_outer_empty_sides():
    """An empty side, dense (FULL_OUTER) and through the merge probe
    (RIGHT_OUTER)."""
    lc = (("k", "INT64", True), ("lv", "INT64", False))
    rc = (("rk", "INT64", True), ("rv", "INT64", False))
    empty_l = _both(lc, {"k": [], "lv": []})
    empty_r = _both(rc, {"rk": [], "rv": []})
    r = _both(rc, {"rk": [1], "rv": [10]})
    l = _both(lc, {"k": [5], "lv": [50]})
    assert _rows(_outer("FULL_OUTER"), empty_l, r) == [(None, None, 1, 10)]
    assert _rows(_outer("FULL_OUTER"), l, empty_r) == [(5, 50, None, None)]
    assert _rows(_outer("RIGHT_OUTER", dense=False), empty_l, r) == \
        [(None, None, 1, 10)]
    assert _rows(_outer("RIGHT_OUTER", dense=False), l, empty_r) == []


@pytest.mark.parametrize("capacity", [None, 9])
def test_outer_joins_capacity_sweep(capacity):
    """tests/test_outer_joins.py's capacity sweep: no capacity padding
    leaks into the rows at any input capacity."""
    ldata = {"k": [1, 2, 2, None], "lv": [10, 20, 21, 40]}
    rdata = {"rk": [2, 3, None], "rv": [200, 300, 999]}
    lc = (("k", "INT64", True), ("lv", "INT64", False))
    rc = (("rk", "INT64", True), ("rv", "INT64", False))
    l, r = _both(lc, ldata, capacity), _both(rc, rdata, capacity)
    assert _canon(_rows(_outer("RIGHT_OUTER"), l, r)) == _canon([
        (2, 20, 2, 200), (2, 21, 2, 200), (None, None, 3, 300),
        (None, None, None, 999)])
    assert _canon(_rows(_outer("FULL_OUTER"), l, r)) == _canon([
        (1, 10, None, None), (2, 20, 2, 200), (2, 21, 2, 200),
        (None, 40, None, None), (None, None, 3, 300),
        (None, None, None, 999)])


def test_full_outer_reserved_marker_name():
    lc = (("k", "INT64", True), ("__full_outer_m", "INT64", False))
    l = _both(lc, {"k": [1], "__full_outer_m": [1]})
    r = _both(R, {"rk": [1], "rv": [1]})
    for i, ns in enumerate((J, T)):
        with pytest.raises(ns.SchemaError, match="reserved"):
            _outer("FULL_OUTER")(ns, l[i], r[i]).bind(ns.BindContext())


@pytest.mark.parametrize("jt", ["RIGHT_OUTER", "FULL_OUTER"])
def test_outer_float_and_multi_keys(jt):
    """(DOUBLE, STRING) key tuples with NaNs and both zeros: the merge
    probe for every join of the rewrite."""
    rng = np.random.default_rng(7)
    vals = [float("nan"), -0.0, 0.0, 1.5, None]
    words = ["a", "b", None]
    lc = (("f", "DOUBLE", True), ("s", "STRING", True), ("i", "INT32", False))
    rc = (("f2", "DOUBLE", True), ("s2", "STRING", True),
          ("j", "INT32", False))
    l = _both(lc, {"f": [vals[i] for i in rng.integers(0, 5, 40)],
                   "s": [words[i] for i in rng.integers(0, 3, 40)],
                   "i": list(range(40))})
    r = _both(rc, {"f2": [vals[i] for i in rng.integers(0, 5, 15)],
                   "s2": [words[i] for i in rng.integers(0, 2, 15)],
                   "j": list(range(15))})
    rows = _rows(_outer(jt, lk=("f", "s"), rk=("f2", "s2"),
                        out_capacity=200), l, r)
    assert any(row[0] is not None and row[3] is not None for row in rows)


@pytest.mark.parametrize("jt", ["RIGHT_OUTER", "FULL_OUTER"])
def test_outer_join_under_group_aggregate_and_sort(jt):
    """A GroupAggregate or Sort over a UNIQUE outer join binds it unmasked
    (it emits rows the lhs does not hold).  The JAX package refuses that
    plan ("masked join binding supports INNER/LEFT_OUTER only"), so it is
    held against the JAX package's rows of the same join under a Project,
    which it does not bind masked."""
    rng = np.random.default_rng(3)
    l = _both(L, {"k": [None if rng.random() < 0.2 else int(v)
                        for v in rng.integers(0, 20, 50)],
                  "lv": [float(v) for v in rng.random(50)]})
    r = _both(R, {"rk": [int(v) for v in rng.permutation(25)[:20]],
                  "rv": [int(v) for v in rng.integers(0, 4, 20)]})

    def agg(ns, a, b, project):
        join = _outer(jt, "UNIQUE")(ns, a, b)
        if project:
            join = ns.Project(ns.Projector.all(), join)
        g = ns.GroupAggregate(["rv"], [ns.AggSpec(ns.Aggregation.SUM, "lv",
                                                  "s"),
                                       ns.AggSpec(ns.Aggregation.COUNT, None,
                                                  "c")], join)
        if ns is J:
            g._pushdown_disabled = True
        return g

    got = T.execute(agg(T, l[1], r[1], False)).to_pylist()
    want = J.execute(agg(J, l[0], r[0], True)).to_pylist()
    assert [(a[0], a[2]) for a in got] == [(b[0], b[2]) for b in want]
    np.testing.assert_allclose([a[1] or 0.0 for a in got],
                               [b[1] or 0.0 for b in want], rtol=1e-12)
    with pytest.raises(J.SchemaError, match="masked"):
        J.execute(agg(J, l[0], r[0], False))
    sort_got = T.execute(T.Sort([T.SortKey("rv"), T.SortKey("lv")],
                                _outer(jt, "UNIQUE")(T, l[1], r[1])))
    sort_want = J.execute(J.Sort([J.SortKey("rv"), J.SortKey("lv")],
                                 J.Project(J.Projector.all(), _outer(
                                     jt, "UNIQUE")(J, l[0], r[0]))))
    assert sort_got.to_pylist() == sort_want.to_pylist()


@pytest.mark.parametrize("stats", [True, False])
def test_full_outer_marker_join_with_and_without_statistics(stats):
    """FULL_OUTER's distinct lhs keys feed the marker join through a
    Compute (no statistics), so it takes the merge probe for INT64 keys,
    and its dense probe over the dictionary for STRING keys; a computed lhs
    has no statistics for the distinct-key group-by either."""
    rng = np.random.default_rng(11)
    lc = (("k", "INT64", True), ("s", "STRING", True),
          ("lv", "DOUBLE", False))
    rc = (("rk", "INT64", True), ("rs", "STRING", False),
          ("rv", "INT64", False))
    l = _both(lc, {"k": [None if rng.random() < 0.1 else int(v)
                         for v in rng.integers(0, 12, 60)],
                   "s": [None if rng.random() < 0.1 else f"s{v}"
                         for v in rng.integers(0, 6, 60)],
                   "lv": [float(v) for v in rng.random(60)]})
    r = _both(rc, {"rk": [int(v) for v in rng.integers(0, 15, 30)],
                   "rs": [f"s{v}" for v in rng.integers(2, 6, 30)],
                   "rv": list(range(30))})

    def lhs(ns, t):
        t = ns.ScanTable(t)
        return t if stats else ns.Compute(
            [ns.col("k"), ns.col("s"), ns.col("lv")], t)

    _rows(_outer("FULL_OUTER", lk=("k", "s"), rk=("rk", "rs"), lhs=lhs,
                 out_capacity=400), l, r)
    _rows(_outer("FULL_OUTER", lk=("s",), rk=("rs",), lhs=lhs,
                 out_capacity=400), l, r)


@pytest.mark.parametrize("keys", [["k"], ["k", "s"]])
def test_group_aggregate_with_keys_and_no_aggregations(keys):
    """FULL_OUTER's distinct-key group-by: group keys and no aggregation
    (not the group-by without keys, tests/test_torch_aggregate_options.py)
    gives the JAX package's distinct keys, in first-occurrence order, NULL
    a key of its own."""
    rng = np.random.default_rng(19)
    data = {"k": [None if rng.random() < 0.1 else int(v)
                  for v in rng.integers(0, 9, 70)],
            "s": [None if rng.random() < 0.1 else f"s{v}"
                  for v in rng.integers(0, 4, 70)]}
    t = _both((("k", "INT64", True), ("s", "STRING", True)), data)
    rows = _rows(lambda ns, a: ns.GroupAggregate(keys, [], ns.ScanTable(a)),
                 t)
    want = list(dict.fromkeys(zip(*[data[k] for k in keys])))
    assert rows == want
