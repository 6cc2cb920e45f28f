#!/usr/bin/env python3
"""Device-time breakdown of one of the port's main-path plans on one CUDA
card.

``headline`` (the default) builds chip_smoke.py's headline tables (100M
fact x 1M dim rows, 64 groups, from default_rng(42)) and profiles the
headline plan; ``dup8`` builds chip_smoke.py's dup8 tables (12.5M fact x 1M
dim rows, 8 dim rows per key) and profiles join (a), the NOT_UNIQUE INNER
join into 100M rows; ``merge`` builds chip_smoke.py's two sorted 50M-row
runs and profiles merge (d), the MergeUnionAll of bench_ops.py:281-299 into
100M rows; ``e`` builds chip_smoke.py's four sorted 25M-row runs and
profiles merge (e), their 4-way MergeUnionAll by (k INT64 nullable ASC, d
DOUBLE DESC) into 100M rows; ``groupby_hi`` profiles chip_smoke.py's
path (g), the sort-path group-by of the headline's 100M fact rows into 1M
keys;
``groupby_few`` profiles its path (j), a DOUBLE SUM of those rows into 64
INT64 keys under a fused Filter; ``merge_probe`` its path (k), the
headline tables' INNER UNIQUE join through the merge probe; ``sparse64``
its path (l), the dup8 join over 64-bit keys past every dense budget;
``join_str`` its path (m), the STRING-key join of 100M probe rows against
a 1M-row build side with a dictionary of its own; ``right_outer`` and
``full_outer`` its path (n), those joins of dup8 (b)'s tables; ``q6``
and ``scalar_distinct`` its path (o), TPC-H Q6's ScalarAggregate over
100M lineitem-shaped rows and the scalar DISTINCT over the headline fact;
``distinct`` its path (p), COUNT(DISTINCT fk) by 64 groups;
``clusters_merge`` and ``clusters_raw`` its path (q), AggregateClusters
over merge (d) and over 100k raw-order clusters; ``clamp`` and
``best_effort`` its path (r), (g) under max_unique_keys_in_result and a
best-effort memory quota; ``topn`` and ``limit`` its path (s), the top 10
of (g) and Limit(25M, 50M) of the fact; ``rowid`` and ``foreign`` its
path (t), RowidMergeJoin and ForeignFilter; ``concat`` its CONCAT
group-by of 1M rows; and the expression engine's paths (u)-(z):
``u_math`` and ``u_round`` the two Computes of (u) over 100M rows,
``v_q14`` and ``w_q12`` TPC-H Q14's and Q12's shapes over (o)'s lineitem
rows, ``x_utc`` and ``x_local`` the date fields of (x) in UTC and in
America/New_York, ``y_stateful`` the stateful scans of (y), ``z_hash``,
``z_groupby`` and ``z_sort`` the hashes, the hash-keyed group-by and the
UINT64 Sort of (z), and ``z_render`` its host render of 1M rows; and the
files and spills of (aa)-(ac): ``aa_save`` and ``aa_load`` the save and
the load of the headline fact (100M rows, in a temporary directory),
``hybrid`` the HybridGroupAggregate of 8M rows spilling 8 chunks and
``spill_sort`` the SortWithTempDirPrefix of 8M rows spilling 8 runs.
Several names profile one after another.  Each
plan runs twice to warm up, then five
runs give the host-clock median (each ends in a sync), then three runs are
profiled with torch.profiler.  Prints the card (nvidia-smi name and power
limit), the median, the wall time per profiled run, the device kernel time
per run (self device time summed over CUDA kernel rows only, since aten op
rows repeat their kernels' time), the busy share (device / wall), the peak
device memory above the inputs, and the table of ops and kernels by device
time.

    python3 scripts/profile_torch_headline.py \
        [headline|dup8|merge|e|groupby_hi|groupby_few|merge_probe|sparse64|
         join_str|right_outer|full_outer|q6|scalar_distinct|
         distinct|clusters_merge|clusters_raw|clamp|best_effort|topn|limit|
         rowid|foreign|concat|u_math|u_round|v_q14|w_q12|x_utc|x_local|
         y_stateful|z_hash|z_groupby|z_sort|z_render|aa_save|aa_load|
         hybrid|spill_sort ...]
"""
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import supersonic_tpu_torch as T  # noqa: E402

WARMUPS, MEDIAN_RUNS, RUNS = 2, 5, 3


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_headline: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(f"card: {smi}")
    for which in sys.argv[1:] or ["headline"]:
        profile_plan(which, torch.device("cuda", 0))
        torch.cuda.empty_cache()


def slice_plan(which, dev):
    """The plan function of a path of (o)-(t) or CONCAT (chip_smoke.py)."""
    S = chip_smoke
    if which == "q6":
        li_t = S.lineitem_table(T, S.lineitem_data(), dev)
        return lambda: S.q6_plan(T, li_t)
    if which == "clusters_merge":
        runs = S.merge_tables(T, S.merge_data(torch, dev), dev)
        return lambda: S.clusters_merge_plan(T, runs)
    fact, dim = S.make_data()
    if which in ("scalar_distinct", "distinct"):
        fg_t = S.fact_g_table(T, fact, dim, dev)[0]
        make = (S.scalar_distinct_plan if which == "scalar_distinct"
                else S.distinct_groupby_plan)
        return lambda: make(T, fg_t)
    if which == "clusters_raw":
        cl_t = S.clusters_raw_table(T, fact["v"], dev)
        return lambda: S.clusters_raw_plan(T, cl_t)
    if which in ("clamp", "best_effort", "topn"):
        hi_t = S.groupby_hi_tables(T, fact, dev)[0]
        if which == "clamp":
            return lambda: S.clamp_plan(T, hi_t)
        if which == "topn":
            return lambda: S.topn_plan(T, hi_t)
        return lambda: S.quota_plan(T, hi_t, "BestEffortGroupAggregate")
    if which == "foreign":
        ff_t, key_t, _ = S.foreign_tables(torch, T, fact, dev)
        return lambda: S.foreign_plan(T, ff_t, key_t)
    if which == "concat":
        codes = np.random.default_rng(12).integers(
            0, len(S.WORDS), S.CONCAT_ROWS).astype(np.int32)
        cc_t = S.concat_table(T, fact, dim, codes, dev)[0]
        return lambda: S.concat_plan(T, cc_t)
    fs, ds = S.schemas(T)
    fact_t = T.Table.from_numpy(fs, fact, device=dev)
    if which == "limit":
        return lambda: T.Limit(S.LIMIT_OFFSET, S.LIMIT_ROWS,
                               T.ScanTable(fact_t))
    if which == "rowid":
        dim_t = T.Table.from_numpy(ds, dim, device=dev)
        return lambda: S.rowid_plan(T, fact_t, dim_t)
    sys.exit(f"profile_torch_headline: unknown plan {which!r}")


def expr_plan(which, dev):
    """The plan function of a path of (u)-(z) (chip_smoke.py)."""
    S = chip_smoke
    if which in ("u_math", "u_round"):
        m_t = S.math_table(T, S.math_data(), dev)
        return lambda: S.math_plans(T, m_t)[which == "u_round"]
    if which in ("v_q14", "w_q12"):
        li = S.lineitem_data()
        tx_t = S.tpch_text_table(T, S.lineitem_table(T, li, dev),
                                 S.text_data(), dev)
        make = S.q14_plan if which == "v_q14" else S.q12_plan
        return lambda: make(T, tx_t)
    if which in ("x_utc", "x_local", "z_render"):
        ts = S.date_data()
        d_t = S.date_table(T, ts, dev)
        if which == "z_render":
            r_t = S.render_table(T, S.make_data()[0], ts, dev)[0]
            return lambda: S.render_plan(T, r_t)
        if which == "x_local":
            T.set_local_timezone(S.LOCAL_ZONE)
            return lambda: S.local_plan(T, d_t)
        return lambda: S.dates_plan(T, d_t)
    if which == "y_stateful":
        s_t = S.stateful_table(T, S.stateful_data(), dev)
        return lambda: S.stateful_plan(T, s_t)
    if which == "z_sort":
        u_t = S.u64_table(T, S.u64_data(), dev)
        return lambda: T.Sort(["u"], T.ScanTable(u_t))
    fact, dim = S.make_data()
    fg_t = S.fact_g_table(T, fact, dim, dev)[0]
    return lambda: S.hash_plans(T, fg_t)[which == "z_groupby"]


def spill_work(which, dev, tmp):
    """One run of a path of (aa)-(ac) (chip_smoke.py), its files under
    ``tmp``."""
    from supersonic_tpu_torch.io import load, save
    from supersonic_tpu_torch.ops.sort import sort_working_set_bytes

    S = chip_smoke
    fact, dim = S.make_data()
    if which in ("aa_save", "aa_load"):
        fact_t = T.Table.from_numpy(S.schemas(T)[0], fact, device=dev)
        path = str(pathlib.Path(tmp) / "fact.sst")
        save(path, fact_t)
        if which == "aa_save":
            return lambda: save(path, fact_t)
        del fact_t
        return lambda: load(path, device=dev)
    if which == "hybrid":
        h_t = T.Table.from_numpy(
            T.TupleSchema.of(("fk", T.INT32, False), ("v", T.FLOAT, False),
                             ("d", T.DOUBLE, False)),
            S.hybrid_data(fact), device=dev)
        quota = S.hybrid_quota(T, h_t, S.SPILL_ROWS // S.SPILL_RUNS)
        return lambda: T.execute(S.hybrid_plan(T, h_t, quota, tmp))
    fg_t = S.fact_g_table(T, fact, dim, dev, n=S.SPILL_ROWS)[0]
    limit = sort_working_set_bytes(fg_t.schema, fg_t.capacity, 2) \
        // S.SPILL_RUNS
    return lambda: T.execute(S.spill_sort_plan(T, fg_t, limit, tmp))


SPILL = ("aa_save", "aa_load", "hybrid", "spill_sort")
EXPRS = ("u_math", "u_round", "v_q14", "w_q12", "x_utc", "x_local",
         "y_stateful", "z_hash", "z_groupby", "z_sort", "z_render")
SLICE = ("q6", "scalar_distinct", "distinct", "clusters_merge",
         "clusters_raw", "clamp", "best_effort", "topn", "limit", "rowid",
         "foreign", "concat")


def earlier_plan(which, dev):
    """The plan function of a path of the headline to (n) (chip_smoke.py)."""
    if which in ("headline", "groupby_hi", "groupby_few", "merge_probe",
                 "join_str"):
        fact, dim = chip_smoke.make_data()
        fs, ds = chip_smoke.schemas(T)
    elif which in ("dup8", "sparse64", "right_outer", "full_outer"):
        fact, dim, fk_half = chip_smoke.dup8_data()
        fs, ds = chip_smoke.dup8_schemas(T)
        if which in ("right_outer", "full_outer"):
            out_cap = chip_smoke.outer_rows(fk_half, dim["pk"])[
                which == "full_outer"]
            fact = dict(fact, fk=fk_half)
    elif which == "merge":
        runs = chip_smoke.merge_tables(T, chip_smoke.merge_data(torch, dev),
                                       dev)
        torch.cuda.empty_cache()
    elif which == "e":
        runs = chip_smoke.merge4_tables(
            T, chip_smoke.merge4_data(torch, dev), dev)
        torch.cuda.empty_cache()
    else:
        sys.exit(f"profile_torch_headline: unknown plan {which!r}")
    if which in ("headline", "dup8", "merge_probe", "right_outer",
                 "full_outer"):
        fact_t = T.Table.from_numpy(fs, fact, device=dev)
        dim_t = T.Table.from_numpy(ds, dim, device=dev)
    if which == "sparse64":
        fact_t, dim_t = chip_smoke.sparse64_tables(T, fact, dim, dev)
    if which == "join_str":
        fact_t, dim_t, _ = chip_smoke.join_str_tables(T, fact, dev)
    if which == "groupby_hi":
        hi_t = chip_smoke.groupby_hi_tables(T, fact, dev)[0]
    if which == "groupby_few":
        d = np.random.default_rng(11).random(chip_smoke.FACT_ROWS) * 2e3 - 1e3
        few_t = chip_smoke.groupby_few_table(T, fact, d, dev)[0]

    def plan():
        if which == "headline":
            return chip_smoke.headline_plan(T, fact_t, dim_t)
        if which == "merge":
            return chip_smoke.merge_plan(T, runs)
        if which == "e":
            return chip_smoke.merge4_plan(T, runs)
        if which == "groupby_hi":
            return chip_smoke.groupby_hi_plan(T, hi_t)
        if which == "groupby_few":
            return chip_smoke.groupby_few_plan(T, few_t)
        if which == "merge_probe":
            return chip_smoke.merge_probe_plan(T, fact_t, dim_t)
        if which == "sparse64":
            return chip_smoke.sparse64_plan(T, fact_t, dim_t)
        if which == "join_str":
            return chip_smoke.join_str_plan(T, fact_t, dim_t)
        if which in ("right_outer", "full_outer"):
            return chip_smoke.outer_plan(
                T, fact_t, dim_t, T.JoinType.RIGHT_OUTER
                if which == "right_outer" else T.JoinType.FULL_OUTER,
                out_cap)
        return chip_smoke.dup8_plan(T, fact_t, dim_t, T.JoinType.INNER, False)

    return plan


def profile_plan(which, dev):
    with tempfile.TemporaryDirectory(prefix="profile_") as tmp:
        if which in SPILL:
            run_once = spill_work(which, dev, tmp)
        else:
            plan = (expr_plan if which in EXPRS else slice_plan
                    if which in SLICE else earlier_plan)(which, dev)

            def run_once():
                T.execute(plan())

        profile_runs(which, run_once)


def profile_runs(which, run_once):
    warnings.simplefilter("ignore")  # the best-effort quota's warning
    print(f"plan: {which}")
    for _ in range(WARMUPS):
        run_once()
    torch.cuda.synchronize()
    times = []
    for _ in range(MEDIAN_RUNS):
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"host-clock median {statistics.median(times):.3f} ms over "
          f"{MEDIAN_RUNS} runs (all: {', '.join(f'{t:.3f}' for t in times)})")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(RUNS):
            run_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / RUNS * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    ka = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA) / RUNS / 1e3
    print(f"wall per run {wall_ms:.3f} ms; device time per run "
          f"{dev_ms:.3f} ms; busy share {dev_ms / wall_ms:.3f}; "
          f"peak extra device memory {peak:.2f} GiB (over {RUNS} runs)")
    print(ka.table(sort_by="self_cuda_time_total", row_limit=40,
                   max_name_column_width=60))


if __name__ == "__main__":
    main()
