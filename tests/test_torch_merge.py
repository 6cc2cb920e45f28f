"""The port's merge slice on the CPU: the merge kernel's plain version
(which its wrapper runs for CPU tensors) against the JAX package's Pallas
merge in interpret mode and against a numpy (keys, side, position) oracle;
the compare words of ``sortable_words``; MergeUnionAll and UnionAll against the
JAX package's on the same seeded numpy inputs (its MergeUnionAll takes its
``lax.sort`` route on the CPU).  The CUDA kernel is held against the same
plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu.kernels import merge_sorted as jax_merge
from supersonic_tpu_torch import kernels
from supersonic_tpu_torch.kernels.merge_sorted import (MergeKey, merge_sorted,
                                                       sortable_words)
from supersonic_tpu_torch.ops.keys import descending_code

from torch_parity import schema

torch.set_num_threads(1)

_TILE = jax_merge.TILE


def _sorted_keys(rng, n, lanes):
    """``lanes`` key lanes of n rows in lexicographic order: (dtype, distinct
    values) per lane."""
    ks = [rng.integers(0, d, n).astype(dt) for dt, d in lanes]
    order = np.lexsort(tuple(reversed(ks)))
    return [k[order] for k in ks]


def _oracle(a_keys, b_keys, a_rows, b_rows):
    """Source of every output row: live rows by (keys, side, position),
    then A's dead rows, then B's."""
    cap_a, cap_b = len(a_keys[0]), len(b_keys[0])
    side = np.r_[np.zeros(cap_a), np.ones(cap_b)]
    pos = np.r_[np.arange(cap_a), np.arange(cap_b)]
    dead = np.r_[np.arange(cap_a) >= a_rows, np.arange(cap_b) >= b_rows]
    keys = [np.where(dead, 0, np.r_[a, b]) for a, b in zip(a_keys, b_keys)]
    return np.lexsort((pos, side) + tuple(reversed(keys)) + (dead,))


@pytest.mark.parametrize("na,nb,kr,seed", [
    (_TILE // 2 + 300, _TILE // 2 - 100, 5, 1),  # heavy ties, about a tile
    (70000, 3, 10**6, 2),                        # wildly uneven
])
def test_merge_matches_jax_kernel(na, nb, kr, seed):
    """Merged keys and payloads equal the Pallas kernel's (interpret mode)
    on every merged row."""
    rng = np.random.default_rng(seed)
    (ka,), (kb,) = (_sorted_keys(rng, n, [(np.int32, kr)]) for n in (na, nb))
    pa = rng.integers(0, 1 << 30, na).astype(np.int32)
    pb = rng.integers(0, 1 << 30, nb).astype(np.int32)
    (wk,), (wp,) = jax_merge.merge_sorted(
        [jnp.asarray(ka)], [jnp.asarray(pa)], [jnp.asarray(kb)],
        [jnp.asarray(pb)], na + nb)
    gk, gp = merge_sorted(
        [torch.from_numpy(ka), torch.from_numpy(pa)],
        [torch.from_numpy(kb), torch.from_numpy(pb)], [MergeKey(0)], na + nb)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk)[:na + nb])
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp)[:na + nb])


@pytest.mark.parametrize("cap_a,cap_b,a_rows,b_rows,lanes,out_frac", [
    (5000, 4000, 5000, 4000, [(np.int32, 3)], 1.0),         # heavy ties
    (3000, 3000, 3000, 3000, [(np.int64, 40), (np.int32, 3),
                              (np.int64, 2**62)], 1.0),      # 3 lanes, int64
    (0, 2500, 0, 2500, [(np.int32, 100)], 1.0),              # empty A
    (2500, 0, 2500, 0, [(np.int64, 100)], 1.0),              # empty B
    (2000, 1500, 1200, 0, [(np.int32, 50)], 1.0),            # B all dead
    (4000, 3000, 2222, 1111, [(np.int32, 60), (np.int64, 5)], 1.0),
    (4000, 3000, 2222, 1111, [(np.int32, 60)], 0.4),         # out_cap < total
    (4000, 3000, 2222, 1111, [(np.int32, 60)], 3333 / 7000),  # = live total
    (1, 7000, 1, 6000, [(np.int64, 10**9)], 1.0),
])
def test_merge_against_numpy_order(cap_a, cap_b, a_rows, b_rows, lanes,
                                   out_frac):
    """Every output row, dead tail included; dead rows hold unsorted keys
    and are never compared; live counts as device scalars (0-d tensors)."""
    rng = np.random.default_rng(cap_a + cap_b + a_rows)

    def side(cap, live):
        ks = _sorted_keys(rng, live, lanes)
        return [np.r_[k, rng.integers(-9, 9, cap - live).astype(k.dtype)]
                for k in ks]

    ak, bk = side(cap_a, a_rows), side(cap_b, b_rows)
    ap = [rng.integers(0, 200, cap_a).astype(np.uint8), rng.random(cap_a)]
    bp = [rng.integers(0, 200, cap_b).astype(np.uint8), rng.random(cap_b)]
    out_cap = round((cap_a + cap_b) * out_frac)
    ta, tb = ([torch.from_numpy(x) for x in arrs] for arrs in (ak + ap, bk + bp))
    keys = [MergeKey(i) for i in range(len(ak))]
    got = merge_sorted(ta, tb, keys, out_cap, torch.tensor(a_rows),
                       torch.tensor(b_rows))
    src = _oracle(ak, bk, a_rows, b_rows)[:out_cap]
    for g, a, b in zip(got, ak + ap, bk + bp):
        assert g.shape == (out_cap,)
        np.testing.assert_array_equal(g.numpy(), np.r_[a, b][src])
    # live counts as python ints give the same rows
    again = merge_sorted(ta, tb, keys, out_cap, a_rows, b_rows)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


def test_merge_rejects_bad_inputs_and_launches_nothing_on_cpu():
    k = torch.arange(4, dtype=torch.int32)
    p = torch.zeros(4)
    ok = torch.ones(4, dtype=torch.bool)
    key = [MergeKey(0)]
    kernels.reset_launches()
    merge_sorted([k, p], [k, p], key, 8)
    assert set(kernels.launches.values()) == {0}  # CPU: no kernel
    for bad in (
            lambda: merge_sorted([k.short()], [k.short()], key, 8),
            lambda: merge_sorted([k], [k.long()], key, 8),
            lambda: merge_sorted([k, p], [k, p], key, 9),
            lambda: merge_sorted([k, p], [k, p.double()], key, 8),
            lambda: merge_sorted([k, p[:3]], [k, p], key, 8),
            lambda: merge_sorted([k], [k], [], 8),
            lambda: merge_sorted([k], [k], [MergeKey(1)], 8),
            lambda: merge_sorted([k, k], [k, k], [MergeKey(0, True, 1)], 8),
            lambda: merge_sorted([k], [k], key * 17, 8),
            lambda: merge_sorted([k, ok], [k, ok], [MergeKey(0, True, 1)] * 9,
                                 8),
            lambda: merge_sorted([k] + [p] * 33, [k] + [p] * 32, key, 8)):
        with pytest.raises(ValueError):
            bad()
    # more lanes than one launch moves
    got = merge_sorted([k] + [p + i for i in range(40)],
                       [k] + [p - i for i in range(40)], key, 8)
    assert [x[:2].tolist() for x in got[1::13]] == [
        [0.0, 0.0], [13.0, -13.0], [26.0, -26.0], [39.0, -39.0]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sortable_words_orders_like_torch_sort(dtype):
    """NaNs of both signs last and equal, -0.0 tied with +0.0, infinities
    and subnormals in place: a stable sort of the words gives the stable
    float sort's permutation, ascending and after descending_code."""
    tiny = torch.finfo(dtype).tiny
    vals = torch.tensor([float("nan"), -float("nan"), 1.0, -float("inf"),
                         -0.0, 0.0, float("inf"), -1.5, tiny / 4, -tiny / 4,
                         0.0, -0.0, 2.0, -float("nan"), -1.5], dtype=dtype)
    for x in (vals, descending_code(vals)):
        w = sortable_words(x)
        assert w.dtype == (torch.int32 if dtype == torch.float32
                           else torch.int64)
        want = torch.sort(x, stable=True).indices
        assert torch.equal(torch.sort(w, stable=True).indices, want)
    assert sortable_words(torch.tensor([True, False])).tolist() == [1, 0]


# --- MergeUnionAll ----------------------------------------------------------

def _tables(cols, parts):
    """(JAX tables, port tables) from the same host data."""
    return ([J.Table.from_data(schema(J, cols), p) for p in parts],
            [T.Table.from_data(schema(T, cols), p, device="cpu")
             for p in parts])


def _host(table):
    """Per column (name, type, nullable, validity, values): values under
    NULL zeroed, floats as their bits (so NaNs of both signs compare),
    strings decoded."""
    n = int(table.num_rows)
    out = []
    for a in table.schema:
        c = table.columns[a.name]
        vals = np.asarray(c.values)[:n]
        ok = (np.ones(n, bool) if c.valid is None
              else np.asarray(c.valid)[:n].astype(bool))
        if a.type.value in ("STRING", "BINARY"):
            vals = np.where(ok, table.dicts[a.name].decode(vals), None)
        else:
            if vals.dtype.kind == "f":
                vals = vals.view(np.int64 if vals.itemsize == 8 else np.int32)
            vals = np.where(ok, vals, 0)
        out.append((a.name, a.type.value, a.nullable, ok, vals))
    return out


def _assert_same_rows(got, want):
    g, w = _host(got), _host(want)
    assert int(got.num_rows) == int(want.num_rows)
    for (gn, gt, gnl, gok, gv), (wn, wt, wnl, wok, wv) in zip(g, w):
        assert (gn, gt, gnl) == (wn, wt, wnl)
        np.testing.assert_array_equal(gok, wok, err_msg=gn)
        np.testing.assert_array_equal(gv, wv, err_msg=gn)
    assert len(g) == len(w)


def _both(plan, js, ts):
    """Run ``plan(ns, tables)`` in both packages; rows must be equal."""
    got = T.execute(plan(T, ts))
    want = J.execute(plan(J, js))
    _assert_same_rows(got, want)
    return got


def _merge(order):
    return lambda ns, ts: ns.MergeUnionAll(order,
                                           [ns.ScanTable(t) for t in ts])


def test_merge_union_mixed_sign_f32_desc():
    """tests/test_kernel_glue.py:49-76's case: f32 DESC keys of both signs
    with zeros."""
    n = 9000
    cols = (("g", "INT32", False), ("v", "FLOAT", False))

    def part(seed):
        r = np.random.default_rng(seed)
        g = r.integers(0, 7, n).astype(np.int32)
        v = (r.random(n, dtype=np.float32) * 4 - 2).astype(np.float32)
        v[r.random(n) < 0.01] = 0.0
        order = np.lexsort((-v, g))
        return {"g": g[order], "v": v[order]}

    js, ts = _tables(cols, [part(1), part(2)])
    _both(_merge([("g", True), ("v", False)]), js, ts)


def test_merge_union_nullable_int64_payload():
    """tests/test_kernel_glue.py:78-101's case: a nullable INT64 payload
    through the fold."""
    n = 7000
    cols = (("g", "INT32", False), ("b", "INT64", True))

    def part(seed):
        r = np.random.default_rng(seed)
        g = np.sort(r.integers(0, 50, n).astype(np.int32))
        b = [None if r.random() < 0.15 else int(r.integers(-2**40, 2**40))
             for _ in range(n)]
        return {"g": g, "b": b}

    js, ts = _tables(cols, [part(1), part(2)])
    _both(_merge([("g", True)]), js, ts)


def test_merge_union_four_children_ties_and_an_empty_child():
    """Four children, many equal keys across them (ties go by child, then
    row); one child empty; nullable key NULL first ascending."""
    rng = np.random.default_rng(3)
    cols = (("k", "INT64", True), ("x", "INT32", False), ("c", "INT32", False))
    order = [("k", True), ("x", False)]
    parts = []
    for i, n in enumerate((700, 0, 1100, 900)):
        k = rng.integers(-3, 4, n)
        x = rng.integers(0, 3, n).astype(np.int32)
        valid = rng.random(n) >= 0.1
        perm = np.lexsort((-x, np.where(valid, k, 0), valid))
        parts.append({"k": [int(v) if ok else None
                            for v, ok in zip(k[perm], valid[perm])],
                      "x": x[perm], "c": np.full(n, i, np.int32)})
    js, ts = _tables(cols, parts)
    got = _both(_merge(order), js, ts)
    assert int(got.num_rows) == 2700


def test_merge_union_of_filter_and_sort_children():
    """Children whose row counts live on the device: a Sort and a Filter
    over a sorted table."""
    rng = np.random.default_rng(8)
    cols = (("k", "INT32", False), ("v", "DOUBLE", True))
    raw = {"k": rng.integers(0, 40, 3000).astype(np.int32),
           "v": [None if rng.random() < 0.2 else float(x)
                 for x in rng.standard_normal(3000)]}
    srt = {"k": np.sort(rng.integers(0, 40, 2000)).astype(np.int32),
           "v": rng.standard_normal(2000)}
    js, ts = _tables(cols, [raw, srt])

    def plan(ns, t):
        return ns.MergeUnionAll(
            [("k", True)],
            [ns.Sort([ns.SortKey("k")], ns.ScanTable(t[0])),
             ns.Filter(ns.col("v") > ns.Const(0.0, ns.DataType.DOUBLE),
                       ns.ScanTable(t[1]))])

    _both(plan, js, ts)


@pytest.mark.parametrize("asc", [True, False])
def test_merge_union_double_keys_with_nan_and_signed_zero(asc):
    """NaNs of both signs sort last ascending and descending, -0.0 ties
    with +0.0, ties go by child: the same rows as the JAX package."""
    cols = (("d", "DOUBLE", False), ("i", "INT32", False))

    def part(seed, n):
        r = np.random.default_rng(seed)
        d = np.round(r.standard_normal(n) * 4) / 2
        u = r.random(n)
        d[u < 0.05] = np.nan
        d[(u >= 0.05) & (u < 0.1)] = -np.nan
        d[(u >= 0.1) & (u < 0.15)] = -0.0
        nan = np.isnan(d)
        perm = np.lexsort((np.where(nan, 0.0, d if asc else -d), nan))
        return {"d": d[perm], "i": np.arange(n, dtype=np.int32) + seed * 1000}

    js, ts = _tables(cols, [part(1, 600), part(2, 500), part(3, 400)])
    got = _both(_merge([("d", asc)]), js, ts)
    nan = np.isnan(got.columns["d"].values.numpy())
    assert nan[-int(nan.sum()):].all()  # NaNs last
    assert np.signbit(got.columns["d"].values.numpy()[nan]).any()  # bits kept


def test_merge_union_string_keys_with_different_dictionaries():
    """STRING keys whose children have their own dictionaries: merged at
    bind, codes remapped, ordered as strings; DESC too."""
    rng = np.random.default_rng(12)
    words = [f"w{i:03d}" for i in range(60)]
    cols = (("s", "STRING", True), ("n", "INT32", False))
    for asc in (True, False):
        parts = []
        for seed in range(3):
            pick = sorted(rng.choice(words[seed * 15: seed * 15 + 30], 200))
            s = [None if rng.random() < 0.1 else w for w in pick]
            valid = np.array([w is not None for w in s])
            rank = np.unique([w or "" for w in s], return_inverse=True)[1]
            # NULL first ascending, last descending
            perm = (np.lexsort((rank, valid)) if asc
                    else np.lexsort((-rank, ~valid)))
            parts.append({"s": [s[i] for i in perm],
                          "n": np.arange(200, dtype=np.int32)})
        js, ts = _tables(cols, parts)
        got = _both(_merge([("s", asc)]), js, ts)
        strs = [r[0] for r in got.to_pylist()]
        live = [x for x in strs if x is not None]
        assert live == sorted(live, reverse=not asc)


@pytest.mark.parametrize("case", ["ints", "tie_break_by_child", "strings"])
def test_merge_union_reference_cases(case):
    """tests/test_merge_rowid.py:10-33 on the port."""
    if case == "strings":
        s = T.TupleSchema.of(("s", T.STRING),)
        a = T.Table.from_data(s, {"s": ["a", "c"]}, device="cpu")
        b = T.Table.from_data(s, {"s": ["b", "d"]}, device="cpu")
        out = T.execute(T.MergeUnionAll(["s"], [T.ScanTable(a),
                                                T.ScanTable(b)]))
        assert [r[0] for r in out.to_pylist()] == ["a", "b", "c", "d"]
        return
    s = T.TupleSchema.of(("k", T.INT64), ("v", T.INT64))
    data = {"ints": ({"k": [1, 3, 5], "v": [10, 30, 50]},
                     {"k": [2, 3, 4], "v": [20, 31, 40]}),
            "tie_break_by_child": ({"k": [1, 1], "v": [1, 2]},
                                   {"k": [1], "v": [3]})}[case]
    a, b = (T.Table.from_data(s, d, device="cpu") for d in data)
    out = T.execute(T.MergeUnionAll(["k"], [T.ScanTable(a), T.ScanTable(b)]))
    if case == "ints":
        assert out.to_pylist() == [(1, 10), (2, 20), (3, 30), (3, 31),
                                   (4, 40), (5, 50)]
    else:  # child 0's rows first (queue order), in child row order
        assert [r[1] for r in out.to_pylist()] == [1, 2, 3]


def test_merge_union_wider_than_one_kernel_launch_matches_jax():
    """17 nullable columns are 34 column lanes, more than one merge launch
    moves (32): the same rows as the JAX package."""
    rng = np.random.default_rng(17)
    cols = [(f"c{i}", "INT32", True) for i in range(17)]

    def part(n):
        data = {c: [None if rng.random() < 0.2 else int(v)
                    for v in rng.integers(-5, 5, n)] for c, _, _ in cols}
        data["c0"] = sorted(data["c0"], key=lambda v: (v is not None, v or 0))
        return data

    js, ts = _tables(cols, [part(300), part(200), part(250)])
    _both(_merge([("c0", True)]), js, ts)


def test_merge_union_rejects_mismatched_schemas():
    a = T.Table.from_data(T.TupleSchema.of(("k", T.INT64)), {"k": [1]},
                          device="cpu")
    b = T.Table.from_data(T.TupleSchema.of(("k", T.INT32)), {"k": [1]},
                          device="cpu")
    with pytest.raises(T.SchemaError):
        T.execute(T.MergeUnionAll(["k"], [T.ScanTable(a), T.ScanTable(b)]))
    with pytest.raises(T.SchemaError):
        T.MergeUnionAll(["k"], [])


# --- UnionAll ---------------------------------------------------------------

def test_union_all_nullable_string_and_filter_children():
    """Nullable output where only one child is nullable, STRING columns
    with different dictionaries, a Filter child whose count is on the
    device, and an empty child."""
    rng = np.random.default_rng(5)
    cols = (("a", "INT32", True), ("s", "STRING", False),
            ("x", "DOUBLE", False))

    def part(n, lo):
        return {"a": [None if rng.random() < 0.2 else int(v)
                      for v in rng.integers(-50, 50, n)],
                "s": [f"t{v:02d}" for v in rng.integers(lo, lo + 20, n)],
                "x": rng.standard_normal(n)}

    parts = [part(300, 0), part(0, 5), part(500, 10), part(200, 30)]
    js, ts = _tables(cols, parts)
    dense = (("a", "INT32", False), ("s", "STRING", False),
             ("x", "DOUBLE", False))
    jd, td = _tables(dense, [{"a": rng.integers(0, 9, 100).astype(np.int32),
                              "s": ["zz", "t05"] * 50,
                              "x": rng.standard_normal(100)}])

    def plan(ns, t, d):
        return ns.UnionAll(
            ns.ScanTable(t[0]), ns.ScanTable(t[1]),
            ns.Filter(ns.col("x") > ns.Const(0.0, ns.DataType.DOUBLE),
                      ns.ScanTable(t[2])),
            ns.ScanTable(d[0]), ns.ScanTable(t[3]))

    got = T.execute(plan(T, ts, td))
    want = J.execute(plan(J, js, jd))
    _assert_same_rows(got, want)
    assert got.schema.lookup("a").nullable
    assert got.dicts["s"].values == tuple(want.dicts["s"].values)
