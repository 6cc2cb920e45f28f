"""The reference's benchmark example workloads on the port, each under the
benchmark harness: the twin of ``examples/operation_example.py``.

    python -m supersonic_tpu_torch.examples.operation_example [--rows N]
        [--out DIR] [--cpu]

Mirrors the reference's ``benchmark/examples/operation_example.cc:24-90``:
(1) a GROUP BY of 50 STRING keys with MAX; (2) Compute ``col0 *
(sin(col2) + exp(col1))``; (3) a two-key Sort (ASC, DESC); (4) a
MergeUnionAll of two sorted inputs; (5) a LEFT_OUTER UNIQUE HashJoin of the
sort's output against the group-by's.  The table is the JAX example's
(``default_rng(7)``, ``--rows`` rows, 100,000 by default).  Each workload
runs under ``bench.benchmark_plan`` (per-node stats, CUDA events on the
card), its ``format_stats`` table goes to stderr and its GraphViz DOT file
to ``--out`` (``chiprun_out/operation_example`` by default).  Each
workload's rows are also checked against numpy (``check``); then ``ok`` is
printed on stdout.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..bench.ops import TRANSCENDENTAL_RTOL, _expect, close, \
    first_occurrence_groups, host_columns, same

ROWS = 100_000
OUT_DIR = os.path.join("chiprun_out", "operation_example")
KEYS = tuple(f"key_{i:02d}" for i in range(50))
NAMES = ("group", "compute", "sort", "union", "join")


def build_data(rows: int = ROWS) -> dict:
    """``examples/operation_example.py:23-37``'s columns from
    ``default_rng(7)``; ``key`` as indices into ``KEYS``."""
    rng = np.random.default_rng(7)
    return {"key": rng.integers(0, 50, rows), "col0": rng.random(rows),
            "col1": rng.random(rows), "col2": rng.random(rows),
            "id": np.arange(rows, dtype=np.int32)}


def build_table(T, data: dict, device="cuda"):
    from ..bench.ops import encode

    codes, words = encode(T, KEYS, data["key"])
    schema = T.TupleSchema.of(("key", T.DataType.STRING, False),
                              ("col0", T.DataType.DOUBLE, False),
                              ("col1", T.DataType.DOUBLE, False),
                              ("col2", T.DataType.DOUBLE, False),
                              ("id", T.DataType.INT32, False))
    return T.Table.from_data(schema, dict(data, key=codes), None,
                             {"key": words}, device=device)


def build_plans(T, t) -> dict:
    """``{name: plan}`` of the five workloads over table ``t``
    (``examples/operation_example.py:56-82``)."""
    group = T.GroupAggregate(
        ["key"], [T.AggSpec(T.Aggregation.MAX, "col0", "max0")],
        T.ScanTable(t), T.GroupAggregateOptions(estimated_result_row_count=64))
    compute = T.Compute(
        (T.col("col0") * (T.Sin(T.col("col2")) + T.Exp(T.col("col1"))))
        .as_("expr"), T.ScanTable(t))
    two_key_sort = T.Sort([("key", True), T.SortKey("col0", ascending=False)],
                          T.ScanTable(t))
    union = T.MergeUnionAll(
        ["col0"], [T.Sort(["col0"], T.ScanTable(t)),
                   T.Sort(["col0"], T.ScanTable(t))])
    join = T.HashJoin(
        T.JoinType.LEFT_OUTER, ["key"], ["key"], two_key_sort, group,
        T.KeyUniqueness.UNIQUE,
        lhs_projector=T.Projector.named("key", "col0"),
        rhs_projector=T.Projector([("max0", "group_max")]))
    return {"group": group, "compute": compute, "sort": two_key_sort,
            "union": union, "join": join}


def check(name: str, out, data: dict) -> int:
    """Workload ``name``'s rows against numpy; returns the row count,
    raises ``bench.ops.Mismatch`` on any difference."""
    cols = host_columns(out)
    val = {k: v for k, (v, _) in cols.items()}
    words = np.asarray(KEYS, dtype=object)
    got_names = [a.name for a in out.schema]
    keys, _, _ = first_occurrence_groups(data["key"])
    mx = np.full(50, -np.inf)
    np.maximum.at(mx, data["key"], data["col0"])
    order = np.lexsort((-data["col0"], data["key"]))
    if name == "group":
        _expect(got_names == ["key", "max0"], f"group: {got_names}")
        _expect(list(val["key"]) == list(words[keys]),
                "group: keys or their order differ from numpy")
        same(val["max0"], mx[keys], "group.max0")
    elif name == "compute":
        _expect(got_names == ["expr"], f"compute: {got_names}")
        close(val["expr"], data["col0"] * (np.sin(data["col2"])
                                           + np.exp(data["col1"])),
              TRANSCENDENTAL_RTOL, "compute.expr")
    elif name == "sort":
        _expect(got_names == ["key", "col0", "col1", "col2", "id"],
                f"sort: {got_names}")
        _expect(list(val["key"]) == list(words[data["key"][order]]),
                "sort: keys differ from numpy")
        for c in ("col0", "col1", "col2", "id"):
            same(val[c], data[c][order], f"sort.{c}")
    elif name == "union":
        # every row twice, run A's copy first on the tie
        twice = np.repeat(np.argsort(data["col0"], kind="stable"), 2)
        _expect(list(val["key"]) == list(words[data["key"][twice]]),
                "union: keys differ from numpy")
        for c in ("col0", "col1", "col2", "id"):
            same(val[c], data[c][twice], f"union.{c}")
    elif name == "join":
        _expect(got_names == ["key", "col0", "group_max"],
                f"join: {got_names}")
        _expect(list(val["key"]) == list(words[data["key"][order]]),
                "join: keys differ from numpy")
        same(val["col0"], data["col0"][order], "join.col0")
        valid = cols["group_max"][1]
        _expect(valid is None or bool(valid.all()),
                "join: a sorted row found no group")
        same(val["group_max"], mx[data["key"][order]], "join.group_max")
    else:
        raise KeyError(name)
    return int(out.num_rows)


def main(rows: int = ROWS, out_dir: str | None = OUT_DIR, device="cuda",
         log=None) -> dict:
    """Run the five workloads under the harness, write their DOT files to
    ``out_dir`` (none when it is None), check each against numpy; returns
    ``{name: NodeStats}``."""
    import supersonic_tpu_torch as T
    from ..bench import benchmark_plan, format_stats, save_dot

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    data = build_data(rows)
    plans = build_plans(T, build_table(T, data, device))
    stats = {}
    for name, plan in plans.items():
        stats[name] = benchmark_plan(plan, iters=1)
        log(f"\n=== {name} ===\n{format_stats(stats[name])}")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            save_dot(stats[name], os.path.join(out_dir, f"{name}.dot"), name)
        check(name, T.execute(plan), data)
    return stats


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--out", default=OUT_DIR, help="DOT output directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions of the kernels)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("operation_example: no CUDA device (pass --cpu to run on "
                  "the CPU)", file=sys.stderr)
            return 2
    main(args.rows, args.out, device)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
