#!/usr/bin/env python3
"""Device time of each step of the join's merge probe on one CUDA card, at
chip_smoke.py's path (k) shape: the headline tables' fk (100M probe rows)
against pk (1M build rows), int32 codes.

Times (CUDA-event medians, ``chip_smoke.cuda_ms``) every step of
``ops/hash_join.py::_merge_probe`` in turn on the tensors the step before
made: the stable joint sort, the row ids to int32, the build flags at the
sorted row ids, the prefix sum, the run boundaries, the run starts carried
over their runs, the scatter back to probe order and the compaction of the
live build rows.  Beside them, the alternatives measured once: the build
flags by ``torch.cat`` + an index, ``torch.cummax`` for the run starts (at
101M and at path (l)'s 13.5M rows), the scatter by ``scatter_`` and
``index_copy_``, and for a single key ``torch.searchsorted`` of the probe
codes into the sorted build codes (lower and upper bound) after a stable
sort of the build side, which the port does not take (one route for every
key count).  Then the whole probe, and a stable sort of path (l)'s 13.5M
int64 codes.  Prints the card (nvidia-smi name and power limit) and one
line per step.

    python3 scripts/measure_torch_merge_probe.py
"""
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from supersonic_tpu_torch.kernels.compaction import compact_kernel  # noqa
from supersonic_tpu_torch.kernels.lut_gather import lut_gather  # noqa: E402
from supersonic_tpu_torch.ops.hash_join import _merge_probe  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("measure_torch_merge_probe: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    fact, dim = chip_smoke.make_data()
    pcode = torch.from_numpy(fact["fk"]).to(dev)
    bcode = torch.from_numpy(dim["pk"]).to(dev)
    rcap, lcap = bcode.shape[0], pcode.shape[0]
    n = rcap + lcap
    blive = torch.ones(rcap, dtype=torch.bool, device=dev)
    pin = torch.ones(lcap, dtype=torch.bool, device=dev)

    def line(step, fn, **kw):
        print(f"{step}: {chip_smoke.cuda_ms(torch, fn, **kw):.3f} ms",
              flush=True)

    cat = torch.cat([bcode, pcode])
    line("cat of the codes", lambda: torch.cat([bcode, pcode]))
    line("stable sort (101M int32, int64 ids)",
         lambda: torch.sort(cat, stable=True))
    first, order = torch.sort(cat, stable=True)
    line("row ids to int32", lambda: order.to(torch.int32))
    order32 = order.to(torch.int32)
    line("build flags: lut_gather",
         lambda: (order32 < rcap) & lut_gather([blive], order32, rcap)[0])
    line("build flags: cat + index (not taken)",
         lambda: torch.cat([blive, torch.zeros(lcap, dtype=torch.bool,
                                               device=dev)])[order])
    isb = (order32 < rcap) & lut_gather([blive], order32, rcap)[0]
    line("prefix sum", lambda: torch.cumsum(isb, 0, dtype=torch.int32))
    bprefix = torch.cumsum(isb, 0, dtype=torch.int32)

    def bounds():
        b = torch.ones(n, dtype=torch.bool, device=dev)
        b[1:] = first[1:] != first[:-1]
        return b

    line("run boundaries", bounds)
    boundary = bounds()
    start = bprefix - isb.to(torch.int32)

    def run_starts():
        (starts,), _ = compact_kernel([start], boundary, n)
        run_id = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
        return lut_gather([starts], run_id, n)[0]

    line("run starts: compaction + run id + lut_gather", run_starts)
    run_start = run_starts()
    line("run starts: torch.cummax (not taken)",
         lambda: torch.cummax(torch.where(boundary, start, 0), 0),
         reps=1, calls=1)
    small = torch.where(boundary, start, 0)[:13_500_000]
    line("run starts: torch.cummax at 13.5M rows (not taken)",
         lambda: torch.cummax(small, 0), reps=3, calls=1)
    pair = torch.empty(n, 2, dtype=torch.int32, device=dev)
    pair[:, 0] = bprefix - run_start
    pair[:, 1] = run_start
    words = pair.view(torch.int64).view(n)
    back = torch.empty(n, dtype=torch.int64, device=dev)
    line("scatter back: index_put", lambda: back.__setitem__(order, words))
    line("scatter back: scatter_ (not taken)",
         lambda: back.scatter_(0, order, words))
    line("scatter back: index_copy_ (not taken)",
         lambda: back.index_copy_(0, order, words))
    line("live build rows: compaction",
         lambda: compact_kernel([order32], isb, rcap))
    line("whole merge probe", lambda: _merge_probe([bcode], [pcode], blive,
                                                   pin))

    def searchsorted():
        sb, _ = torch.sort(bcode, stable=True)
        lo = torch.searchsorted(sb, pcode)
        hi = torch.searchsorted(sb, pcode, right=True)
        return lo, hi

    line("single key: build sort + searchsorted lower and upper "
         "(not taken)", searchsorted)
    sparse = torch.from_numpy(np.concatenate([
        chip_smoke.sparse_key(np.arange(chip_smoke.DUP_DIM_ROWS) // 8),
        chip_smoke.sparse_key(np.random.default_rng(42).integers(
            0, chip_smoke.DUP_KEYS, chip_smoke.DUP_FACT_ROWS))])).to(dev)
    line("stable sort (13.5M int64, path (l))",
         lambda: torch.sort(sparse, stable=True))


if __name__ == "__main__":
    main()
