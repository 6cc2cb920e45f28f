"""HybridGroupAggregate under a memory quota in the port: the chunked
pregroup on the device, the spill through the external sort, the
clustered combine (the hybrid cases of tests/test_quota.py).  Three plans
are held row for row against the JAX package (its spill costs seconds a
call on the CPU); the rest against the port's in-memory GroupAggregate or
numpy, integer sums and counts exact, float sums within PARITY.md's
tolerance."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu_torch.io import external as TX
from torch_parity import bit_rows

torch.set_num_threads(1)

SUM, MIN, MAX, COUNT = "SUM", "MIN", "MAX", "COUNT"


def spec(ns, agg, inp, out, **kw):
    return ns.AggSpec(getattr(ns.Aggregation, agg), inp, out, **kw)


def int_table(ns, n=900, keys=300, seed=3, vals=50):
    """tests/test_quota.py's table: k and v INT64."""
    rng = np.random.default_rng(seed)
    kw = {} if ns is J else {"device": "cpu"}
    return ns.Table.from_data(
        ns.TupleSchema.of(("k", ns.DataType.INT64, False),
                          ("v", ns.DataType.INT64, False)),
        {"k": rng.integers(0, keys, n), "v": rng.integers(0, vals, n)}, **kw)


def hybrid(ns, specs, child, quota, tmp, **opts):
    return ns.HybridGroupAggregate(
        ["k"], specs, child, ns.GroupAggregateOptions(memory_quota=quota,
                                                      **opts),
        temporary_directory_prefix=str(tmp))


def in_memory(specs, t):
    return sorted(T.execute(T.GroupAggregate(["k"], specs,
                                             T.ScanTable(t))).to_pylist())


def test_hybrid_spills_beyond_quota_like_jax(tmp_path):
    """300 keys under a quota of ~40 rows: the strict operator raises, the
    hybrid completes with the JAX package's rows in key order."""
    def run(ns):
        specs = [spec(ns, SUM, "v", "sv"), spec(ns, COUNT, "v", "c"),
                 spec(ns, MIN, "v", "mn"), spec(ns, MAX, "v", "mx")]
        return ns.execute(hybrid(ns, specs, ns.ScanTable(int_table(ns)),
                                 17 * 40, tmp_path)).to_pylist()

    got = run(T)
    assert got == run(J)
    assert [r[0] for r in got] == sorted(r[0] for r in got)
    specs = [spec(T, SUM, "v", "sv"), spec(T, COUNT, "v", "c"),
             spec(T, MIN, "v", "mn"), spec(T, MAX, "v", "mx")]
    with pytest.raises(T.exprs.base.EvaluationError, match="overflow"):
        T.execute(T.GroupAggregate(["k"], specs, T.ScanTable(int_table(T)),
                                   T.GroupAggregateOptions(
                                       memory_quota=17 * 40)))
    assert got == in_memory(specs, int_table(T))
    assert not list(tmp_path.iterdir()), "spill files left behind"


def test_hybrid_string_key_and_nullable_input_like_jax(tmp_path):
    """A STRING key (its codes re-coded into the bind's dictionary after
    the spill's merges) over a nullable input."""
    def table(ns):
        rng = np.random.default_rng(5)
        n = 500
        words = [f"key{i:03d}" for i in range(90)]
        kw = {} if ns is J else {"device": "cpu"}
        return ns.Table.from_data(
            ns.TupleSchema.of(("k", ns.DataType.STRING, False),
                              ("v", ns.DataType.INT64, True)),
            {"k": [words[i] for i in rng.integers(0, 90, n)],
             "v": [None if rng.random() < 0.2 else int(rng.integers(0, 100))
                   for _ in range(n)]}, **kw)

    def plan(ns, t):
        return hybrid(ns, [spec(ns, SUM, "v", "sv"),
                           spec(ns, COUNT, "v", "c")], ns.ScanTable(t),
                      30 * 20, tmp_path)

    t = table(T)
    out = T.execute(plan(T, t))
    assert out.to_pylist() == J.execute(plan(J, table(J))).to_pylist()
    assert out.dicts["k"] is t.dicts["k"]
    assert sorted(out.to_pylist()) == in_memory(
        [spec(T, SUM, "v", "sv"), spec(T, COUNT, "v", "c")], t)


def test_hybrid_distinct_rides_extended_key_like_jax(tmp_path):
    """COUNT DISTINCT and SUM DISTINCT join the pregroup key
    (hybrid_group_utils.h:20-66) and stay exact through the spill."""
    def run(ns):
        specs = [spec(ns, COUNT, "v", "cd", distinct=True),
                 spec(ns, SUM, "v", "sd", distinct=True),
                 spec(ns, SUM, "v", "sv"), spec(ns, COUNT, "v", "c")]
        return ns.execute(hybrid(
            ns, specs, ns.ScanTable(int_table(ns, 700, 120, 11, 12)),
            17 * 40, tmp_path)).to_pylist()

    got = run(T)
    assert got == run(J)
    specs = [spec(T, COUNT, "v", "cd", distinct=True),
             spec(T, SUM, "v", "sd", distinct=True),
             spec(T, SUM, "v", "sv"), spec(T, COUNT, "v", "c")]
    assert got == in_memory(specs, int_table(T, 700, 120, 11, 12))


def test_hybrid_without_quota_is_plain_group_aggregate():
    t = int_table(T, 300, 40)
    got = T.execute(T.HybridGroupAggregate(["k"], [spec(T, SUM, "v", "sv")],
                                           T.ScanTable(t)))
    want = T.execute(T.GroupAggregate(["k"], [spec(T, SUM, "v", "sv")],
                                      T.ScanTable(t)))
    assert got.to_pylist() == want.to_pylist()


def test_hybrid_empty_input(tmp_path):
    t = T.Table.from_data(
        T.TupleSchema.of(("k", T.DataType.INT64, False),
                         ("v", T.DataType.INT64, False)), {"k": [], "v": []},
        device="cpu")
    got = T.execute(hybrid(T, [spec(T, SUM, "v", "sv")], T.ScanTable(t), 64,
                           tmp_path))
    assert got.to_pylist() == []


def test_hybrid_bind_is_pure(monkeypatch):
    """Binding a spilling plan runs no spill: the ExternalSorter runs only
    in prepare_leaves, when the plan executes (the reference's hybrid
    cursor drains its child at the first Next(), aggregate_groups.cc:
    332-431).  tests/test_quota.py's plan, against numpy."""
    from supersonic_tpu_torch.ops.base import compile_plan, prepare_leaves

    calls = []
    orig = TX.ExternalSorter.__init__

    def counting(self, *a, **kw):
        calls.append(1)
        orig(self, *a, **kw)

    monkeypatch.setattr(TX.ExternalSorter, "__init__", counting)
    rng = np.random.default_rng(0)
    n = 5000
    k = rng.integers(0, 2000, n).astype(np.int32)
    v = rng.random(n, dtype=np.float32)
    t = T.Table.from_data(T.TupleSchema.of(("k", T.DataType.INT32, False),
                                           ("v", T.DataType.FLOAT, False)),
                          {"k": k, "v": v}, device="cpu")
    plan = T.HybridGroupAggregate(
        ["k"], [spec(T, SUM, "v", "sv")], T.ScanTable(t),
        T.GroupAggregateOptions(memory_quota=4096))
    run, _bound, leaves = compile_plan(plan)
    assert not calls, "bind executed the spill"
    assert run.lazy, "the spill registered no lazy leaf"
    out, _flags, _names = run(prepare_leaves(leaves, run.lazy))
    assert calls, "prepare did not run the spill"
    got = out.to_pylist()
    keys = np.unique(k)
    assert [r[0] for r in got] == keys.tolist()
    want = np.bincount(k, weights=v.astype(np.float64))[keys]
    np.testing.assert_allclose([r[1] for r in got], want, rtol=1e-5)


@pytest.mark.parametrize("what", ["concat", "first_with_distinct"])
def test_hybrid_rejections_match_jax(what, tmp_path):
    for ns in (J, T):
        if what == "concat":
            specs = [ns.AggSpec(ns.Aggregation.CONCAT, "v", "cv")]
        else:
            specs = [spec(ns, COUNT, "v", "cd", distinct=True),
                     ns.AggSpec(ns.Aggregation.FIRST, "v", "fv")]
        with pytest.raises(ns.SchemaError):
            ns.execute(hybrid(ns, specs, ns.ScanTable(int_table(ns, 50, 5)),
                              200, tmp_path))


def test_hybrid_result_past_its_declared_capacity_raises(tmp_path):
    t = int_table(T, 400, 100)
    with pytest.raises(T.exprs.base.EvaluationError,
                       match="hybrid aggregate result exceeds"):
        T.execute(hybrid(T, [spec(T, SUM, "v", "sv")], T.ScanTable(t), 17 * 8,
                         tmp_path, estimated_result_row_count=50))


def test_hybrid_float_and_double_sums_nullable_keys_against_numpy(tmp_path):
    """FLOAT and DOUBLE sums over a nullable INT32 key (a NULL group), under
    a Sort (which binds the aggregate unordered): keys and counts exact,
    sums within rtol 1e-5 of float64 (PARITY.md:217-221), MIN and MAX
    exact.  A group of huge DOUBLE values beside small ones is held to
    numpy, not to the JAX package's fixed-point sum (a known soft spot)."""
    rng = np.random.default_rng(17)
    n = 3000
    k = rng.integers(0, 400, n).astype(np.int32)
    kv = rng.random(n) > 0.05
    f = rng.standard_normal(n).astype(np.float32)
    d = rng.standard_normal(n)
    d[k == 7] *= 1e300
    t = T.Table.from_numpy(
        T.TupleSchema.of(("k", T.DataType.INT32, True),
                         ("f", T.DataType.FLOAT, False),
                         ("d", T.DataType.DOUBLE, False)),
        {"k": (k, kv), "f": f, "d": d}, device="cpu")
    specs = [spec(T, SUM, "f", "sf"), spec(T, SUM, "d", "sd"),
             spec(T, COUNT, None, "c"), spec(T, MIN, "f", "mn"),
             spec(T, MAX, "d", "mx")]
    out = T.execute(T.Sort(["k"], hybrid(T, specs, T.ScanTable(t), 16 * 64,
                                         tmp_path))).to_pylist()
    groups = [None] + sorted(set(k[kv].tolist()))
    assert [r[0] for r in out] == groups
    for row in out:
        sel = ~kv if row[0] is None else (kv & (k == row[0]))
        assert row[3] == int(sel.sum())
        np.testing.assert_allclose(row[1], f[sel].astype(np.float64).sum(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(row[2], d[sel].sum(), rtol=1e-12)
        assert row[4] == float(f[sel].min()) and row[5] == float(d[sel].max())


def test_hybrid_cluster_wider_than_a_batch(tmp_path):
    """One extended-key (k, v) cluster holding more partial rows than a
    batch (every chunk emits it): that cluster combines on its own and
    the DISTINCT counts stay exact."""
    n = 2000
    t = T.Table.from_data(
        T.TupleSchema.of(("k", T.DataType.INT64, False),
                         ("v", T.DataType.INT64, False)),
        {"k": np.zeros(n, np.int64), "v": np.arange(n) % 3}, device="cpu")
    specs = [spec(T, COUNT, "v", "cd", distinct=True),
             spec(T, COUNT, None, "c"), spec(T, SUM, "v", "sv")]
    got = T.execute(hybrid(T, specs, T.ScanTable(t), 17 * 4, tmp_path))
    assert got.to_pylist() == [(0, 3, n, int((np.arange(n) % 3).sum()))]
    assert bit_rows(got.to_pylist()) == bit_rows(in_memory(specs, t))
