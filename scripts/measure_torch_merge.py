#!/usr/bin/env python3
"""Device time of the merge kernel's launches at the shapes of
chip_smoke.py's merge paths, on one CUDA card.

(d): two sorted 50M-row runs of (g INT32 in [0, 64), v FLOAT in [0, 1))
merged by (g ASC, v DESC), made on the card from a seeded generator; (e):
chip_smoke.py's four sorted 25M-row runs (k INT64 nullable, d DOUBLE with
NaNs of both signs, s STRING codes), folded pairwise by (k ASC, d DESC) as
MergeUnionAll folds them, step by step.  Each call is profiled 5 times
after a warm-up with torch.profiler; the script prints, per shape, the
device time of the splits launch and of the merge launch(es) per call.

``--root DIR`` imports ``supersonic_tpu_torch`` from DIR instead of this
checkout, so the same script measures a checkout of another commit whose
``merge_sorted`` takes raw lanes and ``MergeKey``s.

    python3 scripts/measure_torch_merge.py [--root DIR]
"""
import argparse
import importlib.util
import pathlib
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

HERE = pathlib.Path(__file__).resolve().parent.parent
REPS = 5
RUN_ROWS = 50_000_000


def kernel_ms(fn):
    """Device ms per call of the merge and splits kernels of fn()."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {"splits": 0.0, "merge": 0.0}
    for e in prof.key_averages():
        for name in out:
            if f"{name}_kernel" in e.key:
                out[name] += e.self_device_time_total / REPS / 1e3
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_torch_merge: no CUDA device")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import supersonic_tpu_torch as T
    from supersonic_tpu_torch.kernels import merge_sorted as MS

    # this checkout's data helpers, whatever tree the package comes from
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(f"card: {smi}; package from {args.root}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cuda").manual_seed(5)
    runs = []
    for _ in range(2):
        gg = torch.randint(0, 64, (RUN_ROWS,), device=dev, generator=g,
                           dtype=torch.int32)
        vv = torch.rand(RUN_ROWS, device=dev, generator=g)
        desc = 0x3F800000 - vv.view(torch.int32).to(torch.int64)
        p = torch.sort((gg.to(torch.int64) << 32) | desc, stable=True).indices
        runs.append([gg[p], vv[p]])
    d_keys = [MS.MergeKey(0), MS.MergeKey(1, False)]
    print("(d)", kernel_ms(lambda: MS.merge_sorted(runs[0], runs[1], d_keys,
                                                   2 * RUN_ROWS)))
    del runs
    tables = smoke.merge4_tables(T, smoke.merge4_data(torch, dev), dev)
    e_keys = [MS.MergeKey(0, True, 1), MS.MergeKey(2, False)]
    sides = [[t.columns["k"].values, t.columns["k"].valid,
              t.columns["d"].values, t.columns["s"].values] for t in tables]
    acc = sides[0]
    for i, run in enumerate(sides[1:]):
        cap = acc[0].shape[0] + run[0].shape[0]
        a = acc
        print(f"(e) step {i + 1}, {cap} rows",
              kernel_ms(lambda: MS.merge_sorted(a, run, e_keys, cap)))
        acc = MS.merge_sorted(acc, run, e_keys, cap)


if __name__ == "__main__":
    main()
