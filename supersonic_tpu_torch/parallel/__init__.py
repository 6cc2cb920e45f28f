"""Distributed execution over ``torch.distributed`` (SURVEY.md §2.9, §5.8).

Port of ``supersonic_tpu/parallel``: the same names, over process groups
(NCCL between cards, gloo between CPU processes) in place of a TPU mesh.
"""
from .dist import (AXIS, Mesh, check_exchange_overflow, collect_table,
                   combine_specification, dist_group_aggregate,
                   dist_hash_join, dist_hash_join_ring, dist_hash_join_skew,
                   dist_map, dist_sort, distribute_table, make_mesh,
                   run_local_plan, shuffle, table_row_bytes)
from .hashing import combine_hash, hash_of_pairs, partition_of
from .multihost import global_mesh, initialize, is_multihost, spawn


def dryrun(n_devices: int, device="cuda") -> None:
    """Run one step of the full distributed pipeline (filter -> join ->
    group-by -> sort), the ring join, the skew join and an exchange that
    must overflow, over ``n_devices`` ranks, at shapes large enough to
    exercise the exchange's near-capacity behavior, and check each against
    a host recomputation: the group-by's keys, counts and sums, the sort's
    global order, the ring join's row count, the skew join's rows, and the
    overflow's error.

    Inside a process group it runs on this rank (every rank calls it).
    Without one it spawns ``n_devices`` ranks: on cards 0..n-1 over NCCL,
    or over gloo when ``device="cpu"``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        _dryrun_rank(n_devices, device)
        return
    spawn(n_devices, _dryrun_rank, (n_devices, device), device=device)


def _dryrun_rank(n_devices: int, device) -> None:
    import numpy as np

    from .. import (AggSpec, Aggregation, Const, DataType, Filter, JoinType,
                    KeyUniqueness, ScanTable, Table, TupleSchema, col)
    from ..exprs.base import EvaluationError

    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    rng = np.random.default_rng(0)
    n, m = 4096, 512
    fk = rng.integers(0, m, n).astype(np.int32)
    v = rng.random(n, dtype=np.float32)
    g = rng.integers(0, 8, m).astype(np.int32)
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"fk": fk, "v": v}, device=dev)
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": np.arange(m, dtype=np.int32), "g": g}, device=dev)
    dfact = distribute_table(fact, mesh)
    ddim = distribute_table(dim, mesh, keys=["pk"])
    # derived (shard_cap/P-scaled) per-peer caps: the overflow-checked
    # sizing the real pipeline uses, NOT a generous explicit cap
    filtered = dist_map(
        mesh,
        lambda t: run_local_plan(
            lambda tt: Filter(col("v") > Const(0.25, DataType.FLOAT),
                              ScanTable(tt)), t),
        dfact)
    joined = dist_hash_join(mesh, JoinType.INNER, ["fk"], ["pk"], filtered,
                            ddim, KeyUniqueness.UNIQUE)
    agg = dist_group_aggregate(
        mesh, joined, ["g"],
        [AggSpec(Aggregation.SUM, "v", "sv"),
         AggSpec(Aggregation.COUNT, None, "c")])
    out = dist_sort(mesh, agg, ["g"])
    ring = dist_hash_join_ring(mesh, JoinType.INNER, ["fk"], ["pk"],
                               filtered, ddim)
    # validate against a host recomputation (exchange correctness, not
    # just liveness)
    keep = v > 0.25
    gj = g[fk[keep]]
    sums = np.zeros(8, np.float64)
    counts = np.zeros(8, np.int64)
    np.add.at(sums, gj, v[keep].astype(np.float64))
    np.add.at(counts, gj, 1)
    rows = collect_table(out, mesh).to_pylist()
    keys = [r[0] for r in rows]
    _check(keys == sorted(keys), f"dist_sort: keys out of order: {keys}")
    got = {int(r[0]): (r[1], int(r[2])) for r in rows}
    _check(len(got) == len(rows), "dist_sort: a group twice")
    _check(set(got) == set(np.flatnonzero(counts)), "group set mismatch")
    for gid, (sv, c) in got.items():
        _check(c == counts[gid], f"COUNT mismatch for group {gid}")
        _check(abs(sv - sums[gid]) <= 1e-3 * max(abs(sums[gid]), 1),
               f"SUM mismatch for group {gid}")
    ring_rows = int(collect_table(ring, mesh).num_rows)
    _check(ring_rows == int(keep.sum()), "ring join row count mismatch")

    # the skew hot-key broadcast join: 60% of probe rows hit one key;
    # validated against a host join recomputation.  Hot probe rows stay on
    # their rank, so a peer buffer holds a whole partition (the JAX
    # dryrun's 1024 holds one at 4 or more ranks)
    fk_s = np.where(rng.random(n) < 0.6, 7,
                    rng.integers(0, m, n)).astype(np.int32)
    lv = np.arange(n, dtype=np.int32)
    skew_lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("lv", DataType.INT32, False)),
        {"fk": fk_s, "lv": lv}, device=dev)
    skew_out = dist_hash_join_skew(
        mesh, JoinType.INNER, ["fk"], ["pk"],
        distribute_table(skew_lhs, mesh), ddim, KeyUniqueness.UNIQUE,
        out_cap_per_peer=max(1024, -(-n // mesh.size)), hot_cap=4096,
        min_frac=0.05)
    want = sorted((int(a), int(b), int(a), int(g[a]))
                  for a, b in zip(fk_s, lv))
    got_rows = sorted(tuple(int(x) for x in r)
                      for r in collect_table(skew_out, mesh).to_pylist())
    _check(got_rows == want, "skew join mismatch vs host recomputation")

    # an exchange overflow must RAISE (ERROR_MEMORY_EXCEEDED semantics,
    # memory.h:465), never silently drop: every row shares one key, so
    # the shuffle funnels into one deliberately undersized peer
    hot = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.INT32, False)),
        {"fk": np.zeros(512, dtype=np.int32),
         "v": np.arange(512, dtype=np.int32)}, device=dev)
    try:
        dist_group_aggregate(
            mesh, distribute_table(hot, mesh), ["fk"],
            [AggSpec(Aggregation.SUM, "v", "sv", distinct=True)],
            out_cap_per_peer=8)
    except EvaluationError as e:
        _check("exchange overflow" in str(e), f"the overflow raised {e}")
    else:
        raise AssertionError("skewed exchange overflow did not raise")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun: {what}")


__all__ = [
    "AXIS", "Mesh", "check_exchange_overflow", "collect_table",
    "combine_hash", "combine_specification", "dist_group_aggregate",
    "dist_hash_join", "dist_hash_join_ring", "dist_hash_join_skew",
    "dist_map", "dist_sort", "distribute_table", "dryrun", "global_mesh",
    "hash_of_pairs", "initialize", "is_multihost", "make_mesh",
    "partition_of", "run_local_plan", "shuffle", "spawn", "table_row_bytes",
]
