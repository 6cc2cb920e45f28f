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
DOUBLE DESC) into 100M rows; ``pushdown`` profiles the headline plan
through the aggregate pushdown binding (chip_smoke.py's path (i), under
its Sort); ``groupby_hi`` profiles chip_smoke.py's path (g), the
sort-path group-by of the headline's 100M fact rows into 1M keys;
``groupby_few`` profiles its path (j), a DOUBLE SUM of those rows into 64
INT64 keys under a fused Filter.  The
plan runs twice to warm up, then five
runs give the host-clock median (each ends in a sync), then three runs are
profiled with torch.profiler.  Prints the card (nvidia-smi name and power
limit), the median, the wall time per profiled run, the device kernel time
per run (self device time summed over CUDA kernel rows only, since aten op
rows repeat their kernels' time), the busy share (device / wall), the peak
device memory above the inputs, and the table of ops and kernels by device
time.

    python3 scripts/profile_torch_headline.py \
        [headline|dup8|merge|e|pushdown|groupby_hi|groupby_few]
"""
import pathlib
import statistics
import subprocess
import sys
import time

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
    dev = torch.device("cuda", 0)
    which = sys.argv[1] if len(sys.argv) > 1 else "headline"
    if which in ("headline", "pushdown", "groupby_hi", "groupby_few"):
        fact, dim = chip_smoke.make_data()
        fs, ds = chip_smoke.schemas(T)
    elif which == "dup8":
        fact, dim, _ = chip_smoke.dup8_data()
        fs, ds = chip_smoke.dup8_schemas(T)
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
    if which in ("headline", "dup8", "pushdown"):
        fact_t = T.Table.from_numpy(fs, fact, device=dev)
        dim_t = T.Table.from_numpy(ds, dim, device=dev)
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
        if which == "pushdown":
            return chip_smoke.pushdown_plans(T, fact_t, dim_t)[0][0]
        if which == "groupby_hi":
            return chip_smoke.groupby_hi_plan(T, hi_t)
        if which == "groupby_few":
            return chip_smoke.groupby_few_plan(T, few_t)
        return chip_smoke.dup8_plan(T, fact_t, dim_t, T.JoinType.INNER, False)

    print(f"plan: {which}")
    for _ in range(WARMUPS):
        T.execute(plan())
    torch.cuda.synchronize()
    times = []
    for _ in range(MEDIAN_RUNS):
        t0 = time.perf_counter()
        T.execute(plan())
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
            T.execute(plan())
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
