"""BASELINE.json configs 2-4 at their own scale, on one card: the port's
twin of ``scripts/bench_configs.py``.

    python -m supersonic_tpu_torch.bench.configs [--cpu]

Four plans, with ``scripts/bench_configs.py:70-140``'s labels, data (drawn
in its order from ``default_rng(0)``) and options: a group-by of 10M rows
into 50 STRING keys with four aggregates, a group-by of the same rows into
about 3.9M INT32 keys, a Sort of 100M rows by (k ASC, v DESC) over k <
2^30, and an INNER UNIQUE join of 100M probe rows against 1M build rows.
Each config's tables are freed before the next one's data are drawn.

For each it prints, on stderr, the first run's time (kernel build included)
on a line of its own, then ``scripts/bench_configs.py``'s line: the best of
``ops.REPEATS`` runs of ``execute`` on the host clock, with the CUDA-event
time beside it.  The JAX script's compile-time ceilings (a remote-AOT
compile-budget guard) have no counterpart: nothing is compiled ahead of
time here.  Every result is checked against numpy (``check``): keys,
counts and order exact, f32 sums within ``ops.SUM_RTOL``, MIN and MAX and
every sorted or joined value bit for bit.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .ops import SUM_RTOL, _expect, _table, close, encode, \
    first_occurrence_groups, host_columns, same, sort_words, time_plan

N10 = 10_000_000
N100 = 100_000_000
M = 1_000_000
SEED = 0
CAT_WORDS = tuple(f"cat_{i:02d}" for i in range(50))  # bench_configs.py:82

LABELS = (
    ("config2_50", "config2 groupby 10M->50 (4 aggs)"),
    ("config2_hi", "config2 groupby 10M->~3.9M SUM"),
    ("config3_sort", "config3 sort 100M"),
    ("config4_join", "config4 join 100M x 1M"),
)


def build_configs(T, n10: int = N10, n100: int = N100, m: int = M,
                  seed: int = SEED, device="cuda"):
    """Yield ``(key, label, plan, rows, data)`` for the four configs in
    order, drawing each config's data from one generator when it is
    reached and dropping the previous config's tables first (the caller
    drops its own references to a plan and its result before asking for
    the next).  ``T`` is the package: this port, or the JAX package with
    ``device=None``."""
    rng = np.random.default_rng(seed)
    labels = dict(LABELS)
    A = T.Aggregation

    data = {"g": rng.integers(0, 50, n10),
            "k": rng.integers(0, 1 << 22, n10).astype(np.int32),
            "v": rng.random(n10, dtype=np.float32)}
    codes, words = encode(T, CAT_WORDS, data["g"])
    fact2 = _table(T, device, (("g", "STRING"), ("k", "INT32"),
                               ("v", "FLOAT")), dict(data, g=codes),
                   {"g": words})
    del codes
    yield ("config2_50", labels["config2_50"], T.GroupAggregate(
        ["g"], [T.AggSpec(A.SUM, "v", "sv"), T.AggSpec(A.MIN, "v", "mn"),
                T.AggSpec(A.MAX, "v", "mx"), T.AggSpec(A.COUNT, None, "n")],
        T.ScanTable(fact2),
        T.GroupAggregateOptions(estimated_result_row_count=64)), n10, data)
    yield ("config2_hi", labels["config2_hi"], T.GroupAggregate(
        ["k"], [T.AggSpec(A.SUM, "v", "sv")], T.ScanTable(fact2),
        T.GroupAggregateOptions(estimated_result_row_count=1 << 22)),
        n10, data)
    del fact2, data

    data = {"k": rng.integers(0, 1 << 30, n100).astype(np.int32),
            "v": rng.random(n100, dtype=np.float32)}
    big = _table(T, device, (("k", "INT32"), ("v", "FLOAT")), data)
    yield ("config3_sort", labels["config3_sort"],
           T.Sort([("k", True), ("v", False)], T.ScanTable(big)), n100, data)
    del big, data

    data = {"pk": np.arange(m, dtype=np.int32),
            "w": rng.integers(0, 64, m).astype(np.int32)}
    dim = _table(T, device, (("pk", "INT32"), ("w", "INT32")), data)
    data["fk"] = rng.integers(0, m, n100).astype(np.int32)
    data["v"] = rng.random(n100, dtype=np.float32)
    probe = _table(T, device, (("fk", "INT32"), ("v", "FLOAT")),
                   {"fk": data["fk"], "v": data["v"]})
    yield ("config4_join", labels["config4_join"], T.HashJoin(
        T.JoinType.INNER, ["fk"], ["pk"], T.ScanTable(probe),
        T.ScanTable(dim), T.KeyUniqueness.UNIQUE,
        lhs_projector=T.Projector.named("v"),
        rhs_projector=T.Projector.named("w")), n100, data)


def group_min_max(inv, v, groups):
    """float MIN and MAX of ``v`` by group index ``inv`` (0..groups-1)."""
    order = np.argsort(inv.astype(np.min_scalar_type(groups)),
                       kind="stable")
    starts = np.searchsorted(inv[order], np.arange(groups))
    vs = v[order]
    return np.minimum.reduceat(vs, starts), np.maximum.reduceat(vs, starts)


def check(key: str, out, data: dict) -> int:
    """``out`` of config ``key`` against numpy over its ``data``; returns
    the row count, raises ``ops.Mismatch`` on any difference."""
    cols = host_columns(out)
    val = {k: v for k, (v, _) in cols.items()}
    names = [a.name for a in out.schema]
    if key == "config2_50":
        _expect(names == ["g", "sv", "mn", "mx", "n"], f"{key}: {names}")
        keys, counts, sums = first_occurrence_groups(data["g"], data["v"])
        _expect(list(val["g"]) == [CAT_WORDS[i] for i in keys],
                f"{key}: group keys or their order differ from numpy")
        same(val["n"], counts, f"{key}.n")
        close(val["sv"], sums, SUM_RTOL, f"{key}.sv")
        inv = np.searchsorted(np.sort(keys), data["g"])
        mn, mx = group_min_max(inv, data["v"], len(keys))
        rank = np.argsort(np.argsort(keys))  # sorted position of each key
        same(val["mn"], mn[rank], f"{key}.mn")
        same(val["mx"], mx[rank], f"{key}.mx")
    elif key == "config2_hi":
        _expect(names == ["k", "sv"], f"{key}: {names}")
        keys, _, sums = first_occurrence_groups(data["k"], data["v"])
        same(val["k"], keys, f"{key}.k")
        close(val["sv"], sums, SUM_RTOL, f"{key}.sv")
    elif key == "config3_sort":
        _expect(names == ["k", "v"], f"{key}: {names}")
        # equal (k, v) rows are indistinguishable, so the sorted words of
        # the input are the whole expected output
        same(sort_words(val["k"], val["v"]),
             np.sort(sort_words(data["k"], data["v"])), f"{key} rows")
    elif key == "config4_join":
        _expect(names == ["v", "w"], f"{key}: {names}")
        same(val["v"], data["v"], f"{key}.v")
        same(val["w"], data["w"][data["fk"]], f"{key}.w")  # pk = arange
    else:
        raise KeyError(key)
    return int(out.num_rows)


def main(n10: int = N10, n100: int = N100, m: int = M,
         device="cuda") -> dict:
    """Run, check and time the four configs; prints their lines on stderr
    and returns ``{key: best host seconds}``."""
    import supersonic_tpu_torch as T

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    results = {}
    for key, label, plan, rows, data in build_configs(T, n10, n100, m,
                                                      device=device):
        t = time_plan(T, plan)
        log(f"{label}: first run {t.first_s:.3f} s (kernel build included)")
        check(key, t.out, data)
        dev = ("" if t.device_s is None
               else f"  (CUDA events {t.device_s * 1e3:.3f} ms)")
        log(f"{label:<28} {t.host_s * 1e3:9.1f} ms  "
            f"{rows / t.host_s / 1e6:8.1f} M rows/s{dev}")
        results[key] = t.host_s
        del plan, t, data
    return results


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions of the kernels)")
    args = ap.parse_args(argv)
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("bench.configs: no CUDA device (pass --cpu to run on the "
                  "CPU)", file=sys.stderr)
            return 2
    main(device="cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
