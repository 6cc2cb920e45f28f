"""Capacity-edge stress of the port, each case against numpy: the twin of
``scripts/stress_edges.py``.

    python -m supersonic_tpu_torch.bench.stress_edges [--small] [--cpu]

  1. a group-by of 17M INT64 rows into 63 keys (SUM and COUNT): past 2^24
     rows, so a row index, count or running sum held in float32 anywhere
     on the sort path would come out wrong here (the JAX package's reason,
     ``approx_max_k`` bounded by f32, has no counterpart in the port; the
     shape is still the edge to guard);
  2. a NOT_UNIQUE join of 8M probe rows against 100k keys of 3 build rows
     each, whose 24M output rows fill 95% of its ``out_capacity``;
  3. the same join over zipf(1.3)-skewed probe keys at 93% of its
     capacity: the hot key alone expands to millions of rows.

The data are ``scripts/stress_edges.py``'s, drawn in its order from
``default_rng(1)``; ``--small`` takes its CPU sizes (300k rows, 1/64 of the
joins).  Each join's overflow flag is read and must be off, and every
output row is checked in order: probe rows in order, each key's build rows
in build order.  Prints one line a case on stderr, then ``stress_edges:
all OK`` on stdout.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .ops import _expect, host_columns, same

DUP = 3
OVERFLOW = "join result overflow"


def sizes(small: bool):
    """(group-by rows, its capacity, probe rows, join keys) of
    ``scripts/stress_edges.py:34-59``."""
    scale = 64 if small else 1
    n = 300_000 if small else 17_000_000
    cap = n if small else max(n, (1 << 24) + 4096)
    return n, cap, 8_000_000 // scale, 100_000 // scale


def _table(T, device, cols, data, capacity=None):
    schema = T.TupleSchema.of(*[(c, T.DataType.INT64, False) for c in cols])
    return T.Table.from_data(schema, data, capacity, device=device)


def run_flags(plan):
    """Run ``plan`` as ``execute`` does, but return ``(result, {flag name:
    fired})`` read back before the flags are raised."""
    from ..ops.base import compile_plan, finish, prepare_leaves

    run, _bound, leaves = compile_plan(plan)
    out, flags, names = run(prepare_leaves(leaves, run.lazy))
    fired = dict(zip(names, (bool(f) for f in flags.cpu().tolist())))
    finish(run, flags, names)
    return out, fired


def check_groupby(out, k, v) -> int:
    want_sv = np.bincount(k, weights=v.astype(np.float64), minlength=63)
    want_c = np.bincount(k, minlength=63)
    cols = host_columns(out)
    keys = cols["k"][0]
    # integer sums below 2^53: exact in float64
    same(cols["sv"][0], want_sv[keys].astype(np.int64), "case 1 sv")
    same(cols["c"][0], want_c[keys], "case 1 c")
    _expect(sorted(keys.tolist()) == np.flatnonzero(want_c).tolist(),
            "case 1: group keys differ from numpy")
    return len(keys)


def check_join(out, fk, fired, case) -> int:
    """Every row of a NOT_UNIQUE INNER join of probe (fk, pv = row) against
    build (bk = key of row // 3, bv = row), in probe order, each key's
    build rows in order; the overflow flag off."""
    _expect(fired.get(OVERFLOW) is False,
            f"{case}: overflow flag {fired.get(OVERFLOW)}, flags {fired}")
    cols = host_columns(out)
    pv = np.repeat(np.arange(fk.shape[0]), DUP)
    bv = (DUP * fk[:, None] + np.arange(DUP)).ravel()
    same(cols["pv"][0], pv, f"{case} pv")
    same(cols["fk"][0], fk[pv], f"{case} fk")
    same(cols["bk"][0], fk[pv], f"{case} bk")
    same(cols["bv"][0], bv, f"{case} bv")
    return int(out.num_rows)


def main(small: bool = False, device="cuda", log=None) -> dict:
    """Run and check the three cases; returns ``{case: (rows, seconds of
    the run, first call included)}``."""
    import supersonic_tpu_torch as T

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    n, cap, n_probe, n_keys = sizes(small)
    rng = np.random.default_rng(1)
    results = {}

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    # 1. group-by past 2^24 rows
    k = rng.integers(0, 63, n).astype(np.int64)
    v = rng.integers(0, 1000, n).astype(np.int64)
    t = _table(T, device, ("k", "v"), {"k": k, "v": v}, cap)
    out, secs = timed(lambda: T.execute(T.GroupAggregate(
        ["k"], [T.AggSpec(T.Aggregation.SUM, "v", "sv"),
                T.AggSpec(T.Aggregation.COUNT, None, "c")], T.ScanTable(t),
        T.GroupAggregateOptions(estimated_result_row_count=128))))
    groups = check_groupby(out, k, v)
    results["groupby"] = (groups, secs)
    edge = "past" if n > 1 << 24 else "below"
    log(f"1. group-by {n} rows @ cap {cap} ({edge} 2^24): OK, {groups} "
        f"groups ({secs * 1e3:.0f} ms, first call included)")
    del t, out, k, v

    # 2. NOT_UNIQUE join at 95% of out_capacity
    fk = rng.integers(0, n_keys, n_probe).astype(np.int64)
    build = _table(T, device, ("bk", "bv"),
                   {"bk": np.repeat(np.arange(n_keys), DUP),
                    "bv": np.arange(n_keys * DUP)})

    def join(probe_fk, fill):
        probe = _table(T, device, ("fk", "pv"),
                       {"fk": probe_fk, "pv": np.arange(n_probe)})
        plan = T.HashJoin(
            T.JoinType.INNER, ["fk"], ["bk"], T.ScanTable(probe),
            T.ScanTable(build), T.KeyUniqueness.NOT_UNIQUE,
            out_capacity=int(n_probe * DUP / fill))
        return timed(lambda: run_flags(plan))

    (out, fired), secs = join(fk, 0.95)
    rows = check_join(out, fk, fired, "case 2")
    results["join95"] = (rows, secs)
    log(f"2. NOT_UNIQUE join {n_probe}x{DUP} at 95% cap: OK, {rows} rows, "
        f"overflow flag off ({secs * 1e3:.0f} ms, first call included)")
    del out

    # 3. zipf-skewed NOT_UNIQUE join near capacity
    zipf = np.minimum(rng.zipf(1.3, n_probe) - 1, n_keys - 1).astype(
        np.int64)
    (out, fired), secs = join(zipf, 0.93)
    rows = check_join(out, zipf, fired, "case 3")
    hot = int(np.bincount(zipf).max()) * DUP
    results["zipf93"] = (rows, secs)
    log(f"3. zipf-1.3 NOT_UNIQUE join at 93% cap: OK, {rows} rows, the hot "
        f"key {hot} of them, overflow flag off ({secs * 1e3:.0f} ms, first "
        f"call included)")
    return results


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="the CPU sizes: 300k group-by rows, joins / 64")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions of the kernels)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("stress_edges: no CUDA device (pass --cpu to run on the "
                  "CPU)", file=sys.stderr)
            return 2
    main(args.small, device)
    print("stress_edges: all OK")
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
