#!/usr/bin/env python3
"""Device-time breakdown of the port's headline query on one CUDA card.

Builds chip_smoke.py's tables (100M fact x 1M dim rows, 64 groups, from
default_rng(42)), runs the headline plan twice to warm up, then profiles
three runs with torch.profiler.  Prints the card (nvidia-smi name and power
limit), the wall time per query, the device kernel time per query (self
device time summed over CUDA kernel rows only, since aten op rows repeat
their kernels' time), the busy share (device / wall), the peak device
memory above the inputs, and the table of ops and kernels by device time.

    python3 scripts/profile_torch_headline.py
"""
import pathlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import supersonic_tpu_torch as T  # noqa: E402

WARMUPS, RUNS = 2, 3


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_headline: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    fact, dim = chip_smoke.make_data()
    fs, ds = chip_smoke.schemas(T)
    fact_t = T.Table.from_numpy(fs, fact, None, dev)
    dim_t = T.Table.from_numpy(ds, dim, None, dev)
    for _ in range(WARMUPS):
        T.execute(chip_smoke.headline_plan(T, fact_t, dim_t))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(RUNS):
            T.execute(chip_smoke.headline_plan(T, fact_t, dim_t))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / RUNS * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    ka = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA) / RUNS / 1e3
    print(f"wall per query {wall_ms:.3f} ms; device time per query "
          f"{dev_ms:.3f} ms; busy share {dev_ms / wall_ms:.3f}; "
          f"peak extra device memory {peak:.2f} GiB (over {RUNS} runs)")
    print(ka.table(sort_by="self_cuda_time_total", row_limit=40,
                   max_name_column_width=60))


if __name__ == "__main__":
    main()
