"""Distributed-pipeline benchmark of the port (BASELINE.json config 5): the
twin of ``bench_dist.py``.

    python -m supersonic_tpu_torch.bench.dist [--rows N] [--dim N]
        [--devices P] [--cpu] [--analyze] [--out PATH]

``run`` (the default) times the filter -> join -> group-by -> sort
pipeline of ``bench_dist.py:47-63`` over 1 rank and over P ranks and
prints one JSON line, ``dist_pipeline_scaling_efficiency``: the rows/s at
P over P times the rows/s at 1.  ``--analyze`` times each component at
every P of the sweep (1, 2, 4 and P): the local filter, the fact's
exchange, the repartition join against the ring join, the pregroup ->
shuffle -> combine group-by and the sample sort; measures the rows and
bytes of four exchanges (``shuffle(stats_out=...)``, the repo's
``EXCHANGE.json`` record); writes them to ``--out``
(``chiprun_out/exchange_torch.json`` by default; never the repo's
``EXCHANGE.json``) and prints one JSON line, ``dist_component_analysis``:
the ring join's time over the repartition join's at the largest P.

The data are ``bench_dist.py:34-44``'s, which are ``bench.py``'s
(``headline.build_data``: fact (fk, v) of ``--rows`` rows, dim (pk =
arange, g of 64 groups) of ``--dim`` rows, from ``default_rng(42)``).  The
XLA virtual mesh becomes a process group a P: ranks spawned by
``parallel.spawn``, on cards 0..P-1 over NCCL, or CPU processes over gloo
with ``--cpu``.  Inside an existing process group of the right size the
ranks' work runs in it, in place of spawning.  Each ``jax.jit`` of a
component becomes one call on every rank, timed between barriers (a warm-up,
then the best of ``REPS``).  NCCL refuses two ranks on one card, so on a
machine with one card only P = 1 runs and the scaling efficiency is
undefined (printed as null).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import headline

ROWS = 1_000_000
DIM_ROWS = 100_000
REPS = 3
OUT = os.path.join("chiprun_out", "exchange_torch.json")
COMPONENTS = ("filter(local)", "exchange(fact by fk)", "join(repartition)",
              "join(ring/ppermute)", "group-by(pregroup+comb)",
              "sort(sample+range)")


def _aggs(T):
    return [T.AggSpec(T.Aggregation.SUM, "v", "sv"),
            T.AggSpec(T.Aggregation.COUNT, None, "c")]


def local_plan(T, fact_t, dim_t):
    """The pipeline as one single-card plan: the rows ``run`` must give."""
    return T.Sort(["g"], T.GroupAggregate(
        ["g"], _aggs(T), T.HashJoin(
            T.JoinType.INNER, ["fk"], ["pk"],
            T.Filter(T.col("v") > T.Const(0.5, T.FLOAT),
                     T.ScanTable(fact_t)),
            T.ScanTable(dim_t), T.KeyUniqueness.UNIQUE)))


def _filter(mesh, dfact):
    import supersonic_tpu_torch as T
    from ..parallel import dist_map, run_local_plan

    return dist_map(mesh, lambda t: run_local_plan(
        lambda tt: T.Filter(T.col("v") > T.Const(0.5, T.FLOAT),
                            T.ScanTable(tt)), t), dfact)


def pipeline(mesh, dfact, ddim):
    """``bench_dist.py:47-63``: filter, repartition join (derived per-peer
    capacities), pregroup -> shuffle -> combine, sample sort."""
    import supersonic_tpu_torch as T
    from ..parallel import dist_group_aggregate, dist_hash_join, dist_sort

    joined = dist_hash_join(mesh, T.JoinType.INNER, ["fk"], ["pk"],
                            _filter(mesh, dfact), ddim,
                            T.KeyUniqueness.UNIQUE)
    agg = dist_group_aggregate(mesh, joined, ["g"], _aggs(T),
                               out_cap_per_peer=256)
    return dist_sort(mesh, agg, ["g"], out_cap_per_peer=256)


def _synced(mesh):
    import torch

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def barrier_timed(mesh, fn, reps: int = REPS):
    """``(best seconds, result)`` of ``fn`` on every rank: one warm-up call,
    then ``reps`` calls each bounded by barriers (and a device sync), so a
    rank's time covers the slowest rank's work."""
    import torch.distributed as dist

    out = fn()
    best = float("inf")
    for _ in range(reps):
        _synced(mesh)
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        out = fn()
        _synced(mesh)
        dist.barrier(group=mesh.group)
        best = min(best, time.perf_counter() - t0)
    return best, out


def _rank_setup(n_rows, n_dim):
    import supersonic_tpu_torch as T
    from ..parallel import distribute_table, make_mesh

    mesh = make_mesh()
    fact, dim = headline.build_data(n_rows, n_dim)
    fact_t, dim_t = headline.build_tables(T, fact, dim, mesh.device)
    return (T, mesh, fact_t, dim_t, distribute_table(fact_t, mesh),
            distribute_table(dim_t, mesh))


def run_rank(n_rows: int, n_dim: int, reps: int = REPS):
    """One rank of ``run``: ``(best seconds, collected result rows)``."""
    from ..parallel import collect_table

    _, mesh, _, _, dfact, ddim = _rank_setup(n_rows, n_dim)
    secs, out = barrier_timed(mesh, lambda: pipeline(mesh, dfact, ddim),
                              reps)
    return secs, collect_table(out, mesh).to_pylist()


def analyze_rank(n_rows: int, n_dim: int, reps: int = REPS):
    """One rank of ``analyze``: ``({component: best seconds}, {exchange:
    {total_bytes, offmesh_bytes, row_bytes, rows}})``."""
    import torch

    from ..parallel import (dist_group_aggregate, dist_hash_join,
                            dist_hash_join_ring, dist_map, dist_sort,
                            distribute_table, run_local_plan, shuffle,
                            table_row_bytes)
    from ..parallel.dist import _all_sum, _key_dest_fn

    T, mesh, _, dim_t, dfact, ddim = _rank_setup(n_rows, n_dim)
    P = mesh.size
    times = {}

    def rec(name, fn):
        times[name], out = barrier_timed(mesh, fn, reps)
        return out

    # (1) embarrassingly parallel local compute
    filtered = rec("filter(local)", lambda: _filter(mesh, dfact))
    # (2) the exchange alone: the filtered fact by fk
    rec("exchange(fact by fk)", lambda: shuffle(
        mesh, filtered, _key_dest_fn(["fk"], P), None, check=False)[0])
    # (3) repartition join: two shuffles and a local join
    joined = rec("join(repartition)", lambda: dist_hash_join(
        mesh, T.JoinType.INNER, ["fk"], ["pk"], filtered, ddim,
        T.KeyUniqueness.UNIQUE))
    # (4) ring join: the probe stays, the build rotates
    ddim_bykey = distribute_table(dim_t, mesh, keys=["pk"])
    rec("join(ring/ppermute)", lambda: dist_hash_join_ring(
        mesh, T.JoinType.INNER, ["fk"], ["pk"], filtered, ddim_bykey))
    # (5) pregroup -> shuffle -> combine
    agged = rec("group-by(pregroup+comb)", lambda: dist_group_aggregate(
        mesh, joined, ["g"], _aggs(T), out_cap_per_peer=256))
    # (6) sample sort
    rec("sort(sample+range)", lambda: dist_sort(mesh, agged, ["g"],
                                                out_cap_per_peer=256))

    # (7) the rows and bytes the exchanges move (bench_dist.py:213-243)
    def measure(d, keys):
        st = {}
        shuffle(mesh, d, _key_dest_fn(keys, P), None, check=False,
                stats_out=st)
        return {"total_bytes": st["total_bytes"],
                "offmesh_bytes": st["offmesh_bytes"],
                "row_bytes": st["row_bytes"],
                "rows": int(st["sent_rows"].sum())}

    ex = {"fact_shuffle_by_fk": measure(filtered, ["fk"]),
          "dim_shuffle_by_pk": measure(ddim, ["pk"])}
    pre = dist_map(mesh, lambda t: run_local_plan(
        lambda tt: T.BestEffortGroupAggregate(["g"], _aggs(T),
                                              T.ScanTable(tt)), t), joined)
    ex["groupby_pregroup_shuffle"] = measure(pre, ["g"])
    # the ring's build side rotates P - 1 times: the live build rows of
    # every rank, all-reduced
    build_rows = int(_all_sum(mesh, torch.as_tensor(
        ddim_bykey.num_rows, device=mesh.device).reshape(1).to(
            torch.int64))[0])
    rb = table_row_bytes(ddim_bykey.schema)
    ex["ring_build_rotation"] = {
        "total_bytes": (P - 1) * build_rows * rb,
        "offmesh_bytes": (P - 1) * build_rows * rb,
        "row_bytes": rb, "rows": (P - 1) * build_rows}
    return times, ex


def on_ranks(P: int, fn, args: tuple, device, threads=None) -> list:
    """``fn(*args)`` on every rank of a group of ``P``: in this process's
    group when one exists (it must be of size ``P``), else on ``P`` spawned
    ranks (NCCL on the cards, gloo on the CPU); the results by rank."""
    import torch.distributed as dist

    from ..parallel import spawn

    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != P:
            raise ValueError(f"a group of {P} ranks asked inside a process "
                             f"group of {dist.get_world_size()}")
        return [fn(*args)]
    return spawn(P, fn, args, device=device, threads=threads)


def _log_default(msg):
    print(msg, file=sys.stderr, flush=True)


def run(n_rows: int = ROWS, n_dim: int = DIM_ROWS, devices: int = 1,
        device="cuda", reps: int = REPS, threads=None, log=None) -> dict:
    """Time the pipeline at P = 1 and P = ``devices``; prints the JSON
    line and returns ``{"record": it, "per_P": {P: {"seconds", "rows"}}}``
    (``rows``: the collected result rows)."""
    log = log or _log_default
    per_P = {}
    for P in sorted({1, devices}):
        secs, rows = on_ranks(P, run_rank, (n_rows, n_dim, reps), device,
                              threads)[0]
        per_P[P] = {"seconds": secs, "rows": rows}
        log(f"P={P}: {secs * 1e3:8.1f} ms  {n_rows / secs / 1e6:8.1f} M "
            f"rows/s")
    on_cpu = str(device).startswith("cpu")
    if devices == 1:
        eff = None
        log("scaling efficiency: undefined at one rank (NCCL takes one rank "
            "a card; P > 1 needs more cards, or --cpu)")
    else:
        eff = (n_rows / per_P[devices]["seconds"]) / (
            n_rows / per_P[1]["seconds"] * devices)
    if on_cpu:
        log("NOTE: CPU ranks over gloo share one host's cores: this checks "
            "the distributed path; scaling is only meaningful across cards.")
    record = {
        "metric": "dist_pipeline_scaling_efficiency",
        "value": None if eff is None else round(eff, 3),
        "unit": (f"fraction of linear (1->{devices} ranks)"
                 + ("; CPU ranks over gloo, functional check only"
                    if on_cpu else "")
                 + ("; undefined at one rank" if eff is None else "")),
        "vs_baseline": None if eff is None else round(eff / 0.8, 3),
    }
    print(json.dumps(record), flush=True)
    return {"record": record, "per_P": per_P}


def analyze(n_rows: int = ROWS, n_dim: int = DIM_ROWS, devices: int = 1,
            device="cuda", reps: int = REPS, out: str | None = OUT,
            threads=None, log=None) -> dict:
    """Component times and exchange accounting at each P of the sweep (1,
    2, 4 and ``devices``, up to ``devices``); writes the exchange record to
    ``out`` (none when None), prints the JSON line and returns
    ``{"record", "per_P": {str(P): exchanges}, "times": {P: {component:
    seconds}}}``."""
    log = log or _log_default
    sweep = sorted({p for p in (1, 2, 4, devices) if p <= devices})
    log(f"{'P':>2} {'component':<26} {'ms':>9} {'M rows/s':>9}")
    times, exchange = {}, {}
    for P in sweep:
        t, ex = on_ranks(P, analyze_rank, (n_rows, n_dim, reps), device,
                         threads)[0]
        times[P], exchange[str(P)] = t, ex
        for name in COMPONENTS:
            log(f"{P:>2} {name:<26} {t[name] * 1e3:>9.1f} "
                f"{n_rows / t[name] / 1e6:>9.1f}")
        for name, e in ex.items():
            log(f"   P={P} {name}: {e['offmesh_bytes'] / 1e6:.2f} MB "
                f"off-shard / {e['total_bytes'] / 1e6:.2f} MB total")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"fact_rows": n_rows, "dim_rows": n_dim,
                       "per_P": exchange}, f, indent=1)
        log(f"wrote {out} (measured exchange rows and bytes a P)")
    top = times[sweep[-1]]
    on_cpu = str(device).startswith("cpu")
    record = {
        "metric": "dist_component_analysis",
        "value": round(top["join(ring/ppermute)"]
                       / max(top["join(repartition)"], 1e-12), 3),
        "unit": (f"ring/repartition join time ratio at P = {sweep[-1]}"
                 + (" (CPU ranks over gloo)" if on_cpu else "")),
        "vs_baseline": 1.0,
    }
    print(json.dumps(record), flush=True)
    return {"record": record, "per_P": exchange, "times": times}


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--dim", type=int, default=DIM_ROWS)
    ap.add_argument("--devices", type=int, default=None,
                    help="largest P (default: the cards present, or 4 "
                         "with --cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo between CPU processes in place of NCCL")
    ap.add_argument("--analyze", action="store_true",
                    help="component breakdown across a sweep of P")
    ap.add_argument("--out", default=OUT,
                    help="where --analyze writes its exchange record")
    args = ap.parse_args(argv)
    import torch

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("bench.dist: no CUDA device (pass --cpu to run over gloo)",
              file=sys.stderr)
        return 2
    devices = args.devices or (4 if args.cpu else torch.cuda.device_count())
    if args.analyze:
        analyze(args.rows, args.dim, devices, device, out=args.out)
    else:
        run(args.rows, args.dim, devices, device)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
