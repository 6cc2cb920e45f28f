"""Headline benchmark of the port: the filter -> hash-join -> group-by ->
sort pipeline of ``bench.py``, on one card.

    python -m supersonic_tpu_torch.bench.headline [--fact-rows N]
        [--dim-rows N] [--device cuda|cpu]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.  The
data are ``bench.py:29-40``'s (seed 42, 8M fact rows x 1M dim rows, 64
groups) and the plan is ``bench.py:73-86``'s, projectors included.
``execute`` is timed on the host clock, each run ending in its host sync
(the error flags' read), as the median of 5 runs after a warm-up.
``vs_baseline`` is the ratio of the port's rows/s to the single-threaded
numpy pipeline of ``bench.py:43-54``, timed in the same process on the same
host (median of 3).  The result is checked against numpy before the line is
printed: group keys and counts exact, f32 sums within rtol 1e-4 of float64
(PERF.md §2), sv non-increasing.  Details go to stderr.

The builders (``build_data``, ``build_tables``, ``build_plan``) and
``measure`` are functions, so other benchmark scripts can reuse them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

FACT_ROWS = 8_000_000
DIM_ROWS = 1_000_000
GROUPS = 64
SEED = 42
REPEATS = 5
SUM_RTOL = 1e-4


def build_data(fact_rows: int = FACT_ROWS, dim_rows: int = DIM_ROWS):
    """bench.py:29-40's host arrays: fact (fk, v) and dim (pk = arange, g)."""
    rng = np.random.default_rng(SEED)
    fact = {
        "fk": rng.integers(0, dim_rows, fact_rows).astype(np.int32),
        "v": rng.random(fact_rows, dtype=np.float32),
    }
    dim = {
        "pk": np.arange(dim_rows, dtype=np.int32),
        "g": rng.integers(0, GROUPS, dim_rows).astype(np.int32),
    }
    return fact, dim


def numpy_pipeline(fact, dim):
    """bench.py:43-54's single-threaded numpy pipeline: (sums, counts,
    order) with sums in float64, order by sum descending."""
    keep = fact["v"] > 0.5
    fk = fact["fk"][keep]
    v = fact["v"][keep]
    g = dim["g"][fk]  # pk is arange => direct index join
    sums = np.bincount(g, weights=v.astype(np.float64), minlength=GROUPS)
    counts = np.bincount(g, minlength=GROUPS)
    order = np.argsort(-sums, kind="stable")
    return sums, counts, order


def build_tables(T, fact, dim, device="cuda"):
    """The fact and dim Tables of the port on ``device``."""
    fact_t = T.Table.from_numpy(
        T.TupleSchema.of(("fk", T.DataType.INT32, False),
                         ("v", T.DataType.FLOAT, False)), fact, device=device)
    dim_t = T.Table.from_numpy(
        T.TupleSchema.of(("pk", T.DataType.INT32, False),
                         ("g", T.DataType.INT32, False)), dim, device=device)
    return fact_t, dim_t


def build_plan(T, fact_t, dim_t):
    """bench.py:73-86's plan: Filter(v > 0.5) -> INNER UNIQUE join on
    fk = pk projecting v and g -> group by g with SUM(v), COUNT ->
    Sort(sv DESC).  SUM keeps the input type (FLOAT), the reference's
    default output-type rule (aggregation_operators.h)."""
    return T.Sort(
        [T.SortKey("sv", ascending=False)],
        T.GroupAggregate(
            ["g"],
            [T.AggSpec(T.Aggregation.SUM, "v", "sv"),
             T.AggSpec(T.Aggregation.COUNT, None, "c")],
            T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"],
                       T.Filter(T.col("v") > T.Const(0.5, T.DataType.FLOAT),
                                T.ScanTable(fact_t)),
                       T.ScanTable(dim_t), T.KeyUniqueness.UNIQUE,
                       lhs_projector=T.Projector.named("v"),
                       rhs_projector=T.Projector.named("g")),
            T.GroupAggregateOptions(estimated_result_row_count=GROUPS)))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"headline: {what}")


def check_result(out, fact, dim) -> int:
    """The result rows against numpy: group keys and counts exact, sums
    within ``SUM_RTOL`` of float64, sv non-increasing.  Returns the group
    count; raises AssertionError on a mismatch."""
    sums, counts, _ = numpy_pipeline(fact, dim)
    rows = out.to_pylist()
    _check([a.name for a in out.schema] == ["g", "sv", "c"], "columns")
    got = {r[0]: (r[1], r[2]) for r in rows}
    want = {int(k): (sums[k], int(counts[k])) for k in np.nonzero(counts)[0]}
    _check(sorted(got) == sorted(want), "group keys differ")
    for k, (sv, c) in want.items():
        _check(got[k][1] == c, f"count of group {k}")
        np.testing.assert_allclose(got[k][0], sv, rtol=SUM_RTOL)
    svs = [r[1] for r in rows]
    _check(all(a >= b for a, b in zip(svs, svs[1:])), "sv must not increase")
    return len(rows)


def _synced(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(fact_rows: int = FACT_ROWS, dim_rows: int = DIM_ROWS,
            device="cuda", log=None) -> dict:
    """Build the data and tables, run and check the plan, time it and the
    numpy baseline; returns the JSON record."""
    import supersonic_tpu_torch as T

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    fact, dim = build_data(fact_rows, dim_rows)
    base = []
    for _ in range(3):
        t0 = time.perf_counter()
        numpy_pipeline(fact, dim)
        base.append(time.perf_counter() - t0)
    base_s = statistics.median(base)
    fact_t, dim_t = build_tables(T, fact, dim, device)
    out = T.execute(build_plan(T, fact_t, dim_t))  # warm-up
    n = check_result(out, fact, dim)
    times = []
    for _ in range(REPEATS):
        _synced(device)
        t0 = time.perf_counter()
        T.execute(build_plan(T, fact_t, dim_t))
        _synced(device)
        times.append(time.perf_counter() - t0)
    port_s = statistics.median(times)
    log(f"numpy baseline: {base_s * 1e3:.3f} ms (median of 3); port on "
        f"{device}: {port_s * 1e3:.3f} ms (median of {REPEATS}: "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)}); {n} groups match "
        f"numpy")
    rows_s = fact_rows / port_s
    return {"metric": "pipeline_rows_per_s", "value": rows_s,
            "unit": "rows/s", "vs_baseline": base_s / port_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fact-rows", type=int, default=FACT_ROWS)
    ap.add_argument("--dim-rows", type=int, default=DIM_ROWS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("headline: no CUDA device (pass --device cpu to run on "
                  "the CPU)", file=sys.stderr)
            return 2
    print(json.dumps(measure(args.fact_rows, args.dim_rows, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
