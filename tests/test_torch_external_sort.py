"""The port's sorts against the JAX package's: the external merge sort
(the eight cases of tests/test_external_sort.py, row for row against the
JAX package's external sort), ``SortWithTempDirPrefix``, ``ExtendedSort``
(case-insensitive keys, a limit by either route), and the FLOAT key order
of ``Sort`` (ROADMAP fault 5: -0.0 before +0.0, NaN by its sign bit),
which the external sort's device runs share while its host merge lanes
count -0.0 equal to +0.0 and put NaN last, in both packages."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu.io import external as JX
from supersonic_tpu_torch.io import external as TX
from torch_parity import bit_rows

torch.set_num_threads(1)


def _schema(ns):
    return ns.TupleSchema.of(("k", ns.DataType.INT64, True),
                             ("s", ns.DataType.STRING, True),
                             ("v", ns.DataType.DOUBLE, False))


def _kw(ns):
    return {} if ns is J else {"device": "cpu"}


def make_tables(ns, n_rows, n_tables, seed=3):
    """tests/test_external_sort.py's tables."""
    rng = np.random.default_rng(seed)
    tables = []
    for _ in range(n_tables):
        k = [None if rng.random() < 0.05 else int(x)
             for x in rng.integers(0, 50, n_rows)]
        s = [None if rng.random() < 0.05 else f"s{int(x):02d}"
             for x in rng.integers(0, 20, n_rows)]
        v = rng.random(n_rows)
        tables.append(ns.Table.from_data(_schema(ns), {"k": k, "s": s,
                                                       "v": v}, **_kw(ns)))
    return tables


def order(ns):
    return [ns.SortKey("k", ascending=True), ns.SortKey("s", ascending=False)]


def device_sorted_rows(ns, tables):
    big = {"k": [], "s": [], "v": []}
    for t in tables:
        cols = t.to_numpy()
        for n in big:
            big[n].extend(list(cols[n]))
    whole = ns.Table.from_data(_schema(ns), big, **_kw(ns))
    return ns.execute(ns.Sort(order(ns), ns.ScanTable(whole))).to_pylist()


def both(fn):
    """fn(ns, X) in the JAX package and the port: (JAX rows, port rows)."""
    return fn(J, JX), fn(T, TX)


@pytest.mark.parametrize("rows,tables,limit", [(300, 5, 400), (50, 2, 10_000)],
                         ids=["spilling", "single_run"])
def test_external_sort_matches_jax_and_the_device_sort(rows, tables, limit):
    """Spilled runs plus a last in-memory run (or no spill at all): the
    JAX package's rows in order, and the in-memory Sort's keys (ties
    across runs go by the partitions)."""
    want, got = both(lambda ns, X: X.external_sort(
        make_tables(ns, rows, tables), order(ns),
        memory_limit_rows=limit).to_pylist())
    assert bit_rows(got) == bit_rows(want)
    ref = device_sorted_rows(T, make_tables(T, rows, tables))
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    assert sorted(map(repr, got)) == sorted(map(repr, ref))


def test_external_sorter_chunk_stream():
    def chunks(ns, X):
        with X.ExternalSorter(_schema(ns), order(ns),
                              memory_limit_rows=300) as sorter:
            for t in make_tables(ns, 256, 4):
                sorter.write(t)
            return [c.to_pylist() for c in sorter.result_chunks()]

    want, got = both(chunks)
    assert got == want
    assert sum(map(len, got)) == 4 * 256
    keys = [(0, 0) if r[0] is None else (1, r[0]) for c in got for r in c]
    assert keys == sorted(keys)


def test_external_sort_null_ordering():
    def run(ns, X):
        t = ns.Table.from_data(_schema(ns), {
            "k": [3, None, 1, None, 2], "s": ["a", "b", None, "d", None],
            "v": [1.0, 2.0, 3.0, 4.0, 5.0]}, **_kw(ns))
        return X.external_sort([t], order(ns), memory_limit_rows=2
                               ).to_pylist()

    want, got = both(run)
    assert got == want
    assert [r[0] for r in got] == [None, None, 1, 2, 3]


def test_native_merge_matches_streaming_merge():
    """result() takes the C++ k-way merge, result_chunks() the Python heap:
    the same rows, the JAX package's."""
    from supersonic_tpu_torch import native

    assert native.available()

    def run(ns, X):
        s1 = X.ExternalSorter(_schema(ns), order(ns), memory_limit_rows=300)
        s2 = X.ExternalSorter(_schema(ns), order(ns), memory_limit_rows=300)
        try:
            for t in make_tables(ns, 400, 5, seed=11):
                s1.write(t)
                s2.write(t)
            return (s1.result().to_pylist(),
                    [r for c in s2.result_chunks() for r in c.to_pylist()])
        finally:
            s1.close()
            s2.close()

    (jn, js), (tn, ts) = both(run)
    assert tn == ts == jn == js


def _float_tables(ns, x_type, seed=5, n=200, k=3):
    """tests/test_external_sort.py's nullable float key beside a UINT64
    past 2^63, with -0.0, +0.0 and NaNs of both signs among the floats."""
    rng = np.random.default_rng(seed)
    schema = ns.TupleSchema.of(("f", getattr(ns.DataType, x_type), True),
                               ("u", ns.DataType.UINT64, False))
    tabs = []
    for _ in range(k):
        f = [None if rng.random() < 0.1 else float(x) - 0.5
             for x in rng.random(n)]
        f[0], f[1], f[2], f[3] = -0.0, 0.0, float("nan"), -float("nan")
        f[4] = -0.0
        u = [int(x) + (1 << 63) if i % 3 == 0 else int(x)
             for i, x in enumerate(rng.integers(0, 1000, n))]
        tabs.append(ns.Table.from_data(schema, {"f": f, "u": u}, **_kw(ns)))
    return schema, tabs


@pytest.mark.parametrize("x_type", ["DOUBLE", "FLOAT"])
def test_native_merge_float_desc_and_uint64(x_type):
    """A DESC float key and an ASC UINT64 key through three runs: the JAX
    package's rows, -0.0, +0.0 and NaNs of both signs included (a FLOAT
    key's runs sort by its bits, the host merge by value)."""
    def run(ns, X):
        schema, tabs = _float_tables(ns, x_type)
        keys = [ns.SortKey("f", ascending=False),
                ns.SortKey("u", ascending=True)]
        with X.ExternalSorter(schema, keys, memory_limit_rows=150) as s:
            for t in tabs:
                s.write(t)
            return s.result().to_pylist()

    want, got = both(run)
    assert bit_rows(got) == bit_rows(want)
    assert len(got) == 600


@pytest.mark.parametrize("asc", [True, False], ids=["asc", "desc"])
def test_external_sort_of_a_float_key_with_signed_zeros_and_nans(asc):
    """A FLOAT key alone, ±0 and NaNs of both signs in every run: row for
    row the JAX package's external sort, by either merge."""
    def run(ns, X):
        schema, tabs = _float_tables(ns, "FLOAT", seed=9, n=64, k=4)
        keys = [ns.SortKey("f", ascending=asc)]
        with X.ExternalSorter(schema, keys, memory_limit_rows=50) as s:
            for t in tabs:
                s.write(t)
            return s.result().to_pylist()

    want, got = both(run)
    assert bit_rows(got) == bit_rows(want)


FAULT5 = np.array([np.nan, -np.nan, 1, -np.inf, np.inf, 0.0, -0.0, 0.0,
                   -0.0, np.nan], dtype=np.float32)


@pytest.mark.parametrize("nullable", [False, True], ids=["not_null", "null"])
@pytest.mark.parametrize("asc", [True, False], ids=["asc", "desc"])
def test_sort_orders_float_keys_as_jax(asc, nullable):
    """ROADMAP fault 5: Sort over a FLOAT key gives the JAX package's row
    order: -0.0 before +0.0, a NaN by its sign bit, DESC reversed, NULLs
    first ascending and last descending, ties by input order."""
    n = len(FAULT5)
    valid = np.arange(n) % 4 != 2 if nullable else None
    w = np.arange(n, dtype=np.int32)

    def run(ns):
        schema = ns.TupleSchema([
            ns.Attribute("f", ns.DataType.FLOAT, nullable),
            ns.Attribute("w", ns.DataType.INT32, False)])
        if ns is J:
            t = J.Table.from_arrays(schema, {"f": FAULT5, "w": w},
                                    {"f": valid}, n)
        else:
            t = T.Table.from_numpy(schema, {"f": FAULT5 if valid is None
                                            else (FAULT5, valid), "w": w},
                                   device="cpu")
        out = ns.execute(ns.Sort([ns.SortKey("f", asc)], ns.ScanTable(t)))
        return [r[1] for r in out.to_pylist()]

    assert run(T) == run(J)


def test_sort_permutation_keeps_monotone_codes():
    """sort_permutation, as the JAX package's, counts -0.0 equal to +0.0
    and puts NaN last (only sort_table takes the bits' order)."""
    from supersonic_tpu.ops.sort import sort_permutation as jperm
    from supersonic_tpu_torch.ops.sort import sort_permutation as tperm

    schema_j = J.TupleSchema.of(("f", J.DataType.FLOAT, False))
    schema_t = T.TupleSchema.of(("f", T.DataType.FLOAT, False))
    jt = J.Table.from_arrays(schema_j, {"f": FAULT5}, {}, len(FAULT5))
    tt = T.Table.from_numpy(schema_t, {"f": FAULT5}, device="cpu")
    for asc in (True, False):
        want = np.asarray(jperm(jt, J.SortOrder([J.SortKey("f", asc)])))
        got = tperm(tt, T.SortOrder([T.SortKey("f", asc)])).numpy()
        assert got.tolist() == want.tolist()


def test_sort_with_memory_limit_spills_and_matches(tmp_path):
    """reference: sort.h:89-98; a memory_limit below the working set takes
    the external route: the JAX package's rows, the in-memory Sort's
    keys."""
    def run(ns):
        (t,) = make_tables(ns, 400, 1, seed=11)
        return ns.execute(ns.SortWithTempDirPrefix(
            order(ns), ns.ScanTable(t), memory_limit=2048,
            temporary_directory_prefix=str(tmp_path))).to_pylist()

    got, want = run(T), run(J)
    assert bit_rows(got) == bit_rows(want)
    ref = T.execute(T.Sort(order(T), T.ScanTable(
        make_tables(T, 400, 1, seed=11)[0]))).to_pylist()
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    assert sorted(map(repr, got)) == sorted(map(repr, ref))
    assert not list(tmp_path.iterdir()), "spill files left behind"


def test_sort_with_temp_dir_over_float_keys_and_a_projector(tmp_path):
    """The external route over a FLOAT key (±0, NaNs) and a result
    projector: the JAX package's rows."""
    def run(ns):
        schema, tabs = _float_tables(ns, "FLOAT", seed=4, n=300, k=1)
        return ns.execute(ns.SortWithTempDirPrefix(
            [ns.SortKey("f", False), ns.SortKey("u", True)],
            ns.ScanTable(tabs[0]),
            result_projector=ns.Projector.named("u", "f"),
            memory_limit=1024,
            temporary_directory_prefix=str(tmp_path))).to_pylist()

    assert bit_rows(run(T)) == bit_rows(run(J))


def test_sort_with_ample_memory_limit_stays_on_device():
    (t,) = make_tables(T, 100, 1, seed=12)
    op = T.SortWithTempDirPrefix(order(T), T.ScanTable(t),
                                 memory_limit=1 << 30)
    bound, leaves = T.bind_plan(op)
    # the in-memory route: the child's one leaf, no lazy leaf
    assert len(leaves) == 1 and leaves[0] is t
    want = T.execute(T.Sort(order(T), T.ScanTable(t))).to_pylist()
    assert T.execute(op).to_pylist() == want


def test_spill_binds_without_running_the_sort(monkeypatch):
    """SortWithTempDirPrefix's spill, like HybridGroupAggregate's, runs
    only when the plan executes (prepare_leaves), never at bind."""
    from supersonic_tpu_torch.ops.base import compile_plan, prepare_leaves

    calls = []
    orig = TX.ExternalSorter.__init__

    def counting(self, *a, **kw):
        calls.append(1)
        orig(self, *a, **kw)

    monkeypatch.setattr(TX.ExternalSorter, "__init__", counting)
    (t,) = make_tables(T, 400, 1, seed=2)
    run, _bound, leaves = compile_plan(T.SortWithTempDirPrefix(
        order(T), T.ScanTable(t), memory_limit=2048))
    assert not calls and run.lazy
    out, _flags, _names = run(prepare_leaves(leaves, run.lazy))
    assert calls
    assert [r[:2] for r in out.to_pylist()] == \
        [r[:2] for r in device_sorted_rows(T, [t])]


def _words(ns):
    rng = np.random.default_rng(21)
    pool = ["apple", "Apple", "APPLE", "banana", "Banana", "cherry", "b",
            "B", "a", None]
    n = 120
    return ns.Table.from_data(
        ns.TupleSchema.of(("s", ns.DataType.STRING, True),
                          ("x", ns.DataType.FLOAT, False)),
        {"s": [pool[i] for i in rng.integers(0, len(pool), n)],
         "x": rng.standard_normal(n).astype(np.float32)}, **_kw(ns))


@pytest.mark.parametrize("limit", [None, 100, 10],
                         ids=["no_limit", "limit", "top_k"])
@pytest.mark.parametrize("asc", [True, False], ids=["asc", "desc"])
def test_extended_sort_matches_jax(asc, limit):
    """A case-insensitive STRING key then a FLOAT key: without a limit,
    with one (the full sort cut), and with a small one (the top-K route,
    on monotone codes)."""
    def run(ns):
        keys = [ns.SortKey("s", asc, case_sensitive=False),
                ns.SortKey("x", not asc)]
        return ns.execute(ns.ExtendedSort(keys, ns.ScanTable(_words(ns)),
                                          limit=limit)).to_pylist()

    got, want = run(T), run(J)
    assert bit_rows(got) == bit_rows(want)
    assert len(got) == (limit or 120)


def test_extended_sort_rejects_a_case_insensitive_number():
    with pytest.raises(T.SchemaError, match="must be STRING"):
        T.execute(T.ExtendedSort([T.SortKey("x", True, False)],
                                 T.ScanTable(_words(T))))
