"""Distributed scenarios of the port, run on every rank of a process group
by ``tests/test_torch_dist.py`` (not collected).

This module imports the port and numpy only: the ranks are new processes,
and loading JAX in each would cost seconds.  The table builders take a
package namespace (the port or the JAX package) and keyword arguments for
``Table.from_data``, so the test builds the same tables for the JAX
package's mesh.  ``run_all`` runs every scenario on this rank and returns
{name: value}; a scenario that raises gives ("raised", type name,
message).
"""
import warnings

import numpy as np

N_HOT = 400        # tests/test_parallel.py's overflow tables
N_CAPS = 256       # ... and its default-caps table


def fact_dim(ns, kw, n=200, m=40, seed=0):
    """tests/test_parallel.py::make_tables."""
    rng = np.random.default_rng(seed)
    fact = ns.Table.from_data(
        ns.TupleSchema.of(("fk", ns.DataType.INT64, False),
                          ("v", ns.DataType.INT64, False)),
        {"fk": rng.integers(0, m, n), "v": rng.integers(0, 100, n)}, **kw)
    dim = ns.Table.from_data(
        ns.TupleSchema.of(("pk", ns.DataType.INT64, False),
                          ("g", ns.DataType.INT64, False)),
        {"pk": np.arange(m), "g": rng.integers(0, 5, m)}, **kw)
    return fact, dim


def outer_sides(ns, kw):
    """tests/test_parallel.py::test_left_outer_dist_join's tables."""
    lhs = ns.Table.from_data(
        ns.TupleSchema.of(("k", ns.DataType.INT64, False),),
        {"k": [1, 2, 99]}, **kw)
    rhs = ns.Table.from_data(
        ns.TupleSchema.of(("k2", ns.DataType.INT64, False),
                          ("w", ns.DataType.INT64, False)),
        {"k2": [1, 2, 3], "w": [10, 20, 30]}, **kw)
    return lhs, rhs


def full_outer_sides(ns, kw):
    lhs = ns.Table.from_data(
        ns.TupleSchema.of(("k", ns.DataType.INT64, False),
                          ("lv", ns.DataType.INT64, False)),
        {"k": [1, 2, 2, 99], "lv": [10, 20, 21, 990]}, **kw)
    rhs = ns.Table.from_data(
        ns.TupleSchema.of(("k2", ns.DataType.INT64, False),
                          ("w", ns.DataType.INT64, False)),
        {"k2": [2, 3, 4], "w": [200, 300, 400]}, **kw)
    return lhs, rhs


def skew_sides(ns, kw):
    """60% of the probe rows hit key 7."""
    rng = np.random.default_rng(11)
    n, m = 400, 50
    fk = np.where(rng.random(n) < 0.6, 7, rng.integers(0, m, n))
    lhs = ns.Table.from_data(
        ns.TupleSchema.of(("fk", ns.DataType.INT64, False),
                          ("lv", ns.DataType.INT64, False)),
        {"fk": fk, "lv": np.arange(n)}, **kw)
    rhs = ns.Table.from_data(
        ns.TupleSchema.of(("pk", ns.DataType.INT64, False),
                          ("w", ns.DataType.INT64, False)),
        {"pk": np.arange(m), "w": np.arange(m) * 10}, **kw)
    return lhs, rhs


def ring_sides(ns, kw):
    """Some probe keys have no build row; w is nullable."""
    rng = np.random.default_rng(13)
    n, m = 300, 40
    lhs = ns.Table.from_data(
        ns.TupleSchema.of(("fk", ns.DataType.INT64, False),
                          ("lv", ns.DataType.INT64, False)),
        {"fk": rng.integers(0, m + 10, n), "lv": np.arange(n)}, **kw)
    rhs = ns.Table.from_data(
        ns.TupleSchema.of(("pk", ns.DataType.INT64, False),
                          ("w", ns.DataType.INT64, True)),
        {"pk": np.arange(m),
         "w": [None if i % 7 == 0 else i * 10 for i in range(m)]}, **kw)
    return lhs, rhs


def hot_table(ns, kw, n=N_HOT):
    """Every row shares one key."""
    return ns.Table.from_data(
        ns.TupleSchema.of(("fk", ns.DataType.INT64, False),
                          ("v", ns.DataType.INT64, False)),
        {"fk": np.zeros(n, dtype=np.int64),
         "v": np.arange(n, dtype=np.int64)}, **kw)


def exchange_table(ns, kw, n=4000, seed=0):
    """tests/test_exchange_bytes.py::_make."""
    rng = np.random.default_rng(seed)
    return ns.Table.from_data(
        ns.TupleSchema.of(("k", ns.DataType.INT32, False),
                          ("v", ns.DataType.FLOAT, False)),
        {"k": rng.integers(0, 500, n).astype(np.int32),
         "v": rng.random(n, dtype=np.float32)}, **kw)


def keyed_table(ns, kw, n=300, seed=21):
    """Partition keys of each kind: INT32, INT64 past 2^32, a nullable
    INT64 and a STRING (dictionary codes)."""
    rng = np.random.default_rng(seed)
    return ns.Table.from_data(
        ns.TupleSchema.of(("a", ns.DataType.INT32, False),
                          ("b", ns.DataType.INT64, False),
                          ("c", ns.DataType.INT64, True),
                          ("s", ns.DataType.STRING, False)),
        {"a": rng.integers(-1000, 1000, n).astype(np.int32),
         "b": rng.integers(-2**40, 2**40, n),
         "c": [None if rng.random() < 0.2 else int(x)
               for x in rng.integers(0, 30, n)],
         "s": [f"w{int(i)}" for i in rng.integers(0, 17, n)]}, **kw)


SUM_COUNT_MIN_MAX = (("SUM", "v", "sv"), ("COUNT", None, "c"),
                     ("MIN", "v", "mn"), ("MAX", "v", "mx"))


def specs(ns, triples, distinct=False):
    return [ns.AggSpec(getattr(ns.Aggregation, a), i, o, distinct=distinct)
            for a, i, o in triples]


def _local_rows(t):
    return t.to_pylist()


def shards(ns, dt):
    """Each shard's live rows of one of the JAX package's distributed
    tables (its leaves are [P, cap])."""
    out = []
    for p, n in enumerate(np.asarray(dt.num_rows)):
        cols = {}
        for name in dt.schema.names():
            c = dt.columns[name]
            vals = np.asarray(c.values)[p][:n]
            if c.valid is not None:
                ok = np.asarray(c.valid)[p][:n]
                vals = [v.item() if k else None for v, k in zip(vals, ok)]
            cols[name] = vals
        out.append(ns.Table.from_data(dt.schema, cols,
                                      dicts=dict(dt.dicts)).to_pylist())
    return out


def raised(fn):
    """[type name, message] of what ``fn()`` raised, or None."""
    try:
        fn()
    except Exception as e:
        return [type(e).__name__, str(e)]
    return None


def run_all(P):
    """Every scenario on this rank of a group of ``P`` (gloo, CPU)."""
    import torch

    import supersonic_tpu_torch as T
    from supersonic_tpu_torch import parallel as D
    from supersonic_tpu_torch.parallel import dist as DD

    torch.set_num_threads(1)
    mesh = D.make_mesh(P, device="cpu")
    kw = {"device": "cpu"}
    fact, dim = fact_dim(T, kw)

    def collect(t):
        return D.collect_table(t, mesh).to_pylist()

    def roundtrip():
        rr = D.distribute_table(fact, mesh)
        kk = D.distribute_table(fact, mesh, keys=["fk"])
        return {"local": _local_rows(rr), "local_keyed": _local_rows(kk),
                "cap": rr.capacity, "cap_keyed": kk.capacity,
                "collected": collect(rr)}

    def partitions():
        t = keyed_table(T, kw)
        out = {}
        for keys in (["a"], ["b"], ["c"], ["s"], ["a", "c", "s"]):
            out[",".join(keys)] = _local_rows(
                D.distribute_table(t, mesh, keys=keys))
        return out

    def group_aggregate():
        d = D.distribute_table(fact, mesh)
        return collect(D.dist_group_aggregate(
            mesh, d, ["fk"], specs(T, SUM_COUNT_MIN_MAX),
            out_cap_per_peer=256))

    def hash_join(jt):
        return collect(D.dist_hash_join(
            mesh, getattr(T.JoinType, jt), ["fk"], ["pk"],
            D.distribute_table(fact, mesh), D.distribute_table(dim, mesh),
            T.KeyUniqueness.UNIQUE, out_cap_per_peer=256))

    def sort_v():
        return collect(D.dist_sort(mesh, D.distribute_table(fact, mesh),
                                   ["v"], out_cap_per_peer=256))

    def sort_two_keys():
        t = keyed_table(T, kw)
        return collect(D.dist_sort(
            mesh, D.distribute_table(t, mesh),
            [T.SortKey("c", ascending=False), T.SortKey("s")]))

    def shuffle_mod():
        small, _ = fact_dim(T, kw, n=64)

        def dest_fn(local):
            return (local.columns["fk"].values % P).to(torch.int32)

        return collect(D.shuffle(mesh, D.distribute_table(small, mesh),
                                 dest_fn, 64))

    def left_outer():
        lhs, rhs = outer_sides(T, kw)
        return collect(D.dist_hash_join(
            mesh, T.JoinType.LEFT_OUTER, ["k"], ["k2"],
            D.distribute_table(lhs, mesh), D.distribute_table(rhs, mesh),
            T.KeyUniqueness.UNIQUE, out_cap_per_peer=32))

    def skew():
        lhs, rhs = skew_sides(T, kw)
        return collect(D.dist_hash_join_skew(
            mesh, T.JoinType.INNER, ["fk"], ["pk"],
            D.distribute_table(lhs, mesh), D.distribute_table(rhs, mesh),
            T.KeyUniqueness.UNIQUE, out_cap_per_peer=512, hot_cap=64,
            min_frac=0.05))

    def ring(jt):
        lhs, rhs = ring_sides(T, kw)
        return collect(D.dist_hash_join_ring(
            mesh, getattr(T.JoinType, jt), ["fk"], ["pk"],
            D.distribute_table(lhs, mesh),
            D.distribute_table(rhs, mesh, keys=["pk"])))

    def overflow():
        return D.dist_group_aggregate(
            mesh, D.distribute_table(hot_table(T, kw), mesh), ["fk"],
            specs(T, (("SUM", "v", "sv"),), distinct=True),
            out_cap_per_peer=8)

    def join_overflow():
        lhs = T.Table.from_data(
            T.TupleSchema.of(("fk", T.DataType.INT64, False)),
            {"fk": np.zeros(N_HOT, dtype=np.int64)}, **kw)
        rhs = T.Table.from_data(
            T.TupleSchema.of(("pk", T.DataType.INT64, False),
                             ("w", T.DataType.INT64, False)),
            {"pk": np.arange(4), "w": np.arange(4) * 10}, **kw)
        return D.dist_hash_join(
            mesh, T.JoinType.INNER, ["fk"], ["pk"],
            D.distribute_table(lhs, mesh), D.distribute_table(rhs, mesh),
            T.KeyUniqueness.UNIQUE, out_cap_per_peer=8)

    def default_caps():
        d = D.distribute_table(hot_table(T, kw, N_CAPS), mesh,
                               cap_per_shard=N_CAPS)
        return collect(D.dist_group_aggregate(
            mesh, d, ["fk"], specs(T, (("SUM", "v", "sv"),))))

    def quota():
        small, _ = fact_dim(T, kw, n=300, m=30)
        opts = T.GroupAggregateOptions(memory_quota=125)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # per-rank degradation warnings
            return collect(D.dist_group_aggregate(
                mesh, D.distribute_table(small, mesh), ["fk"],
                specs(T, (("SUM", "v", "sv"), ("COUNT", "v", "cv"))),
                options=opts))

    def full_outer(jt):
        lhs, rhs = full_outer_sides(T, kw)
        return collect(D.dist_hash_join(
            mesh, getattr(T.JoinType, jt), ["k"], ["k2"],
            D.distribute_table(lhs, mesh), D.distribute_table(rhs, mesh),
            T.KeyUniqueness.UNIQUE, out_cap_per_peer=32))

    def distinct():
        rng = np.random.default_rng(7)
        n = 500
        t = T.Table.from_data(
            T.TupleSchema.of(("g", T.DataType.INT64, False),
                             ("v", T.DataType.INT64, True)),
            {"g": rng.integers(0, 12, n),
             "v": [None if rng.random() < 0.1 else int(x)
                   for x in rng.integers(0, 9, n)]}, **kw)
        return collect(D.dist_group_aggregate(
            mesh, D.distribute_table(t, mesh), ["g"],
            specs(T, (("SUM", "v", "sv"), ("COUNT", "v", "cv")),
                  distinct=True)))

    def exchange(n, seed):
        t = exchange_table(T, kw, n, seed)
        d = D.distribute_table(t, mesh)
        stats = {}
        out = D.shuffle(mesh, d, DD._key_dest_fn(["k"], P),
                        stats_out=stats)
        dest = DD._key_dest_fn(["k"], P)(d)[:int(d.num_rows)]
        mine = np.bincount(dest.numpy(), minlength=P)
        return {"stats": stats, "mine": mine.tolist(),
                "row_bytes": D.table_row_bytes(t.schema),
                "collected": collect(out) if n <= 4000 else None}

    def deferred_check():
        out, dropped = D.shuffle(
            mesh, D.distribute_table(hot_table(T, kw), mesh),
            DD._key_dest_fn(["fk"], P), 8, check=False)
        D.check_exchange_overflow(dropped)
        return int(dropped)

    def multihost():
        rng = np.random.default_rng(0)  # the same data on every rank
        n = 256
        g = rng.integers(0, 10, n)
        v = rng.integers(0, 100, n)
        t = T.Table.from_data(
            T.TupleSchema.of(("g", T.DataType.INT64, False),
                             ("v", T.DataType.INT64, False)),
            {"g": g, "v": v}, **kw)
        out = D.dist_group_aggregate(
            D.global_mesh(device="cpu"), D.distribute_table(t, mesh), ["g"],
            specs(T, (("SUM", "v", "sv"),)))
        local = out.to_pylist()
        s = torch.tensor([sum(a * b for a, b in local), len(local)])
        torch.distributed.all_reduce(s)
        return {"multihost": D.is_multihost(), "checksum": int(s[0]),
                "groups": int(s[1])}

    def shard_error():
        """A shard flag fires on one rank only; every rank must raise."""
        t = T.Table.from_data(
            T.TupleSchema.of(("x", T.DataType.INT64, False)),
            {"x": [1, 2, 3, 0]}, **kw)
        return D.dist_map(mesh, lambda tt: D.run_local_plan(
            lambda s: T.Compute([T.DivideSignaling(T.Const(10, T.DataType.INT64),
                                          T.col("x"))], T.ScanTable(s)),
            tt), D.distribute_table(t, mesh))

    def dryrun():
        D.dryrun(P, device="cpu")
        return True

    scenarios = {
        "roundtrip": roundtrip, "partitions": partitions,
        "group_aggregate": group_aggregate,
        "join_INNER": lambda: hash_join("INNER"),
        "join_LEFT_OUTER": lambda: hash_join("LEFT_OUTER"),
        "sort_v": sort_v, "sort_two_keys": sort_two_keys,
        "shuffle_mod": shuffle_mod, "left_outer": left_outer, "skew": skew,
        "ring_INNER": lambda: ring("INNER"),
        "ring_LEFT_OUTER": lambda: ring("LEFT_OUTER"),
        "overflow": overflow, "join_overflow": join_overflow,
        "default_caps": default_caps, "quota": quota,
        "full_outer_RIGHT_OUTER": lambda: full_outer("RIGHT_OUTER"),
        "full_outer_FULL_OUTER": lambda: full_outer("FULL_OUTER"),
        "distinct": distinct,
        "exchange": lambda: exchange(4000, 0),
        "exchange_uniform": lambda: exchange(20000, 3),
        "deferred_check": deferred_check, "multihost": multihost,
        "shard_error": shard_error, "dryrun": dryrun,
    }
    results = {}
    for name, fn in scenarios.items():
        try:
            results[name] = fn()
        except Exception as e:  # the test asserts on what was raised
            results[name] = ("raised", type(e).__name__, str(e))
    return results
