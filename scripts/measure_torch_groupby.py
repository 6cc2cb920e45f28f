#!/usr/bin/env python3
"""A measurement of the sort-path group-by's run sums on one CUDA card.

The f64 run sums of a float SUM over 100M sorted rows into 4, 64 and 1M
runs (uniform group ids from a seed): one ``torch.segment_reduce`` over
the runs (CUB's segmented reduce, one thread block a run) beside
``ops/aggregate.py::_run_sums`` (the runs cut into pieces of at most
``tile`` rows, two levels) at each tile of ``TILES``, each timed with CUDA
events beside its bound (values and lengths read once, sums written once,
over 3.35 TB/s), and held against each other within 1e-12 of each run's
sum of |x|.

Prints the card (nvidia-smi name and power limit) and one JSON line a
run count.

    python3 scripts/measure_torch_groupby.py
"""
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from supersonic_tpu_torch.ops import aggregate as TA  # noqa: E402

ROWS = 100_000_000
RUNS = (4, 64, 1_000_000)
TILES = (4096, 32768, 131072)


def run_sums(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand(ROWS, dtype=torch.float64, device=dev,
                   generator=gen) * 2e3 - 1e3
    for g in RUNS:
        ids = torch.randint(g, (ROWS,), device=dev, generator=gen)
        lengths = torch.bincount(ids, minlength=g)
        del ids
        one = torch.segment_reduce(x, "sum", lengths=lengths, unsafe=True)
        sabs = TA._run_sums(x.abs(), lengths)
        two_ms = {}
        err = 0.0
        for tile in TILES:
            two = TA._run_sums(x, lengths, tile)
            err = max(err, float(((one - two).abs()
                                  / sabs.clamp(min=1.0)).max()))
            assert torch.equal(two, TA._run_sums(x, lengths, tile)), \
                "bits differ"
            two_ms[tile] = chip_smoke.cuda_ms(
                torch, lambda: TA._run_sums(x, lengths, tile))
        assert err <= 1e-12, f"run sums disagree: {err}"
        ms_one = chip_smoke.cuda_ms(torch, lambda: torch.segment_reduce(
            x, "sum", lengths=lengths, unsafe=True))
        print(json.dumps({
            "measure": "run_sums", "rows": ROWS, "runs": g,
            "one_level_ms": ms_one, "two_level_ms_by_tile": two_ms,
            "default_tile": TA._SUM_TILE,
            "bound_ms": chip_smoke.bound_ms(8 * ROWS + 16 * g),
            "max_rel_diff": err}), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("measure_torch_groupby: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    run_sums(dev)


if __name__ == "__main__":
    main()
