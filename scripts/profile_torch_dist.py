#!/usr/bin/env python3
"""Where the time of the distributed headline goes, at world size 1 over
NCCL on one CUDA card.

Builds chip_smoke.py's headline tables (100M fact x 1M dim rows, 64
groups, from default_rng(42)) and runs the headline the way chip_smoke.py's
path (ag) does (``distribute_table``, ``dist_map`` of the Filter,
``dist_hash_join``, ``dist_group_aggregate``, ``dist_sort``,
``collect_table``), split into its phases: the two ``distribute_table``
calls, the Filter, the join's probe and build shuffles, the local join,
the pregroup, its shuffle, the final combine, the sort and the collect.
Each phase ends in a device sync; the host-clock median of 5 runs of each
is printed, with the shuffles' share of the whole and each shuffle's
``stats_out`` bytes.  Then the whole run is profiled with torch.profiler
(``profile_torch_headline.profile_runs``: host-clock median, wall and
device time a run, busy share, the op and kernel table).

    python3 scripts/profile_torch_dist.py
"""
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import supersonic_tpu_torch as T  # noqa: E402
from supersonic_tpu_torch import parallel as D  # noqa: E402
from supersonic_tpu_torch.parallel import dist as DD  # noqa: E402

RUNS = 5


def phases(mesh, fact_t, dim_t):
    """One run of the distributed headline as (phase, callable) pairs; each
    callable takes the results so far (a dict) and adds its own."""
    opts = T.GroupAggregateOptions(estimated_result_row_count=C.GROUPS)
    names = ["g"]
    spec = T.AggregationSpecification([
        T.AggSpec(T.Aggregation.SUM, "v", "sv"),
        T.AggSpec(T.Aggregation.COUNT, None, "c")])

    def local(plan_of):
        return lambda t: D.run_local_plan(plan_of, t)

    return [
        ("distribute fact", lambda r: D.distribute_table(fact_t, mesh)),
        ("distribute dim", lambda r: D.distribute_table(dim_t, mesh,
                                                        keys=["pk"])),
        ("Filter", lambda r: D.dist_map(mesh, local(
            lambda t: T.Filter(T.col("v") > T.Const(0.5, T.FLOAT),
                               T.ScanTable(t))), r["distribute fact"])),
        ("shuffle probe", lambda r: D.shuffle(
            mesh, r["Filter"], DD._key_dest_fn(["fk"], 1),
            stats_out=r.setdefault("stats probe", {}))),
        ("shuffle build", lambda r: D.shuffle(
            mesh, r["distribute dim"], DD._key_dest_fn(["pk"], 1),
            r["distribute dim"].capacity,
            stats_out=r.setdefault("stats build", {}))),
        ("local join", lambda r: D.dist_map(mesh, lambda lt, rt: D.run_local_plan(
            lambda _: T.HashJoin(
                T.JoinType.INNER, ["fk"], ["pk"], T.ScanTable(lt),
                T.ScanTable(rt), T.KeyUniqueness.UNIQUE,
                lhs_projector=T.Projector.named("v"),
                rhs_projector=T.Projector.named("g")), lt),
            r["shuffle probe"], r["shuffle build"])),
        ("pregroup", lambda r: D.dist_map(mesh, local(
            lambda t: DD._UnorderedBind(T.BestEffortGroupAggregate(
                names, spec, T.ScanTable(t), opts))), r["local join"])),
        ("shuffle pregroup", lambda r: D.shuffle(
            mesh, r["pregroup"], DD._key_dest_fn(names, 1),
            stats_out=r.setdefault("stats pregroup", {}))),
        ("final combine", lambda r: D.dist_map(mesh, local(
            lambda t: T.GroupAggregate(names, D.combine_specification(spec),
                                       T.ScanTable(t), opts)),
            r["shuffle pregroup"])),
        ("dist_sort", lambda r: D.dist_sort(
            mesh, r["final combine"], [T.SortKey("sv", ascending=False)])),
        ("collect", lambda r: D.collect_table(r["dist_sort"], mesh)),
    ]


def main():
    from profile_torch_headline import profile_runs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    fact, dim = C.make_data()
    fs, ds = C.schemas(T)
    fact_t = T.Table.from_numpy(fs, fact, device=dev)
    dim_t = T.Table.from_numpy(ds, dim, device=dev)
    D.initialize(f"localhost:{D.multihost.free_port()}", 1, 0, device="cuda")
    try:
        mesh = D.make_mesh(1)
        steps = phases(mesh, fact_t, dim_t)
        times = {name: [] for name, _ in steps}
        for run in range(RUNS + 1):  # the first run warms up
            r = {}
            for name, fn in steps:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r[name] = fn(r)
                torch.cuda.synchronize()
                if run:
                    times[name].append((time.perf_counter() - t0) * 1e3)
            if not run:
                C.check_headline(r["collect"], fact, dim)
        med = {k: statistics.median(v) for k, v in times.items()}
        whole = sum(med.values())
        shuffles = sum(v for k, v in med.items() if k.startswith("shuffle"))
        for name, ms in med.items():
            print(f"{name:<18} median {ms:9.3f} ms ({ms / whole:6.1%})")
        print(f"sum of phase medians {whole:.3f} ms; the three shuffles "
              f"{shuffles:.3f} ms, {shuffles / whole:.1%} of it")
        for k in ("stats probe", "stats build", "stats pregroup"):
            s = r[k]
            print(f"{k}: {s['total_bytes']} bytes, {s['row_bytes']} a row, "
                  f"off the card {s['offmesh_bytes']}")

        def whole_run():
            rr = {}
            for name, fn in steps:
                rr[name] = fn(rr)

        profile_runs("distributed headline at world size 1", whole_run)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
