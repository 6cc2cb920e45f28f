#!/usr/bin/env python3
"""Two measurements of the sort-path group-by on one CUDA card.

1. The f64 run sums of a float SUM over 100M sorted rows into 4, 64 and
   1M runs (uniform group ids from a seed): one ``torch.segment_reduce``
   over the runs (CUB's segmented reduce, one thread block a run) beside
   ``ops/aggregate.py::_run_sums`` (the runs cut into pieces of at most
   ``tile`` rows, two levels) at each tile of ``TILES``, each timed with
   CUDA events beside its bound (values and lengths read once, sums
   written once, over 3.35 TB/s), and held against each other within
   1e-12 of each run's sum of |x|.
2. chip_smoke.py's dup8 INNER join (12.5M fact x 1M dim rows, 8 dim rows a
   key, 100M output rows) grouped by the dim's w (SUM v, COUNT(*)) under a
   Sort by the sum: the direct binding (join, then group-by) against the
   aggregate pushdown (pregroup the fact by fk, join the 125k partials,
   aggregate again), host-clock medians of 5 runs each in the order
   direct, pushdown, pushdown, direct, with each binding's launches; the
   rows must agree (keys and counts exact, sums within rtol 1e-4).

Prints the card (nvidia-smi name and power limit) and one JSON line a
measurement.

    python3 scripts/measure_torch_groupby.py
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import supersonic_tpu_torch as T  # noqa: E402
from supersonic_tpu_torch import kernels  # noqa: E402
from supersonic_tpu_torch.ops import aggregate as TA  # noqa: E402

ROWS = 100_000_000
RUNS = (4, 64, 1_000_000)
TILES = (4096, 32768, 131072)
REPEATS = 5


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


def dup8_by_w_plan(fact_t, dim_t, pushdown):
    agg = T.GroupAggregate(
        ["w"], [T.AggSpec(T.Aggregation.SUM, "v", "sv"),
                T.AggSpec(T.Aggregation.COUNT, None, "c")],
        chip_smoke.dup8_plan(T, fact_t, dim_t, T.JoinType.INNER, False),
        T.GroupAggregateOptions(estimated_result_row_count=64))
    agg._pushdown_disabled = not pushdown
    return T.Sort([T.SortKey("sv", ascending=False)], agg)


def dup8_by_w(dev):
    fact, dim, _ = chip_smoke.dup8_data()
    fs, ds = chip_smoke.dup8_schemas(T)
    fact_t = T.Table.from_numpy(fs, fact, device=dev)
    dim_t = T.Table.from_numpy(ds, dim, device=dev)
    outs = {}
    for pushdown in (False, True):
        T.execute(dup8_by_w_plan(fact_t, dim_t, pushdown))  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = T.execute(dup8_by_w_plan(fact_t, dim_t, pushdown))
        torch.cuda.synchronize()
        outs[pushdown] = (sorted(out.to_pylist()), dict(kernels.launches))
    (direct, l_direct), (pushed, l_pushed) = outs[False], outs[True]
    assert [(r[0], r[2]) for r in direct] == [(r[0], r[2]) for r in pushed]
    np.testing.assert_allclose([r[1] for r in pushed],
                               [r[1] for r in direct], rtol=1e-4)
    medians = []
    for pushdown in (False, True, True, False):
        times = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T.execute(dup8_by_w_plan(fact_t, dim_t, pushdown))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        medians.append({"binding": "pushdown" if pushdown else "direct",
                        "median_ms": statistics.median(times),
                        "all_ms": times})
    print(json.dumps({
        "measure": "dup8_by_w", "groups": len(direct),
        "launches_direct": l_direct, "launches_pushdown": l_pushed,
        "turns": medians}), flush=True)


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
    torch.cuda.empty_cache()
    dup8_by_w(dev)


if __name__ == "__main__":
    main()
