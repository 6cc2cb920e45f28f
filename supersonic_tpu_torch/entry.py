"""Entry points of the port, the twins of ``__graft_entry__.py``.

``entry(device)``            — one step of the flagship workload: the
                               filter -> hash-join -> group-by -> sort
                               pipeline at 8192 x 1024 rows (the data and
                               plan of ``__graft_entry__.py:14-59``), bound
                               once by ``compile_plan``.
``dryrun_multichip(n, device)`` — the distributed pipeline over ``n`` ranks
                               (``parallel.dryrun``).

Both run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np


def _make_pipeline(num_rows: int, build_rows: int, device):
    from . import (AggSpec, Aggregation, Const, DataType, Filter,
                   GroupAggregate, GroupAggregateOptions, HashJoin, JoinType,
                   KeyUniqueness, ScanTable, Sort, SortKey, Table,
                   TupleSchema, col)
    from .ops.base import compile_plan

    rng = np.random.default_rng(0)
    fact_schema = TupleSchema.of(
        ("fk", DataType.INT32, False), ("v", DataType.FLOAT, False))
    dim_schema = TupleSchema.of(
        ("pk", DataType.INT32, False), ("g", DataType.INT32, False))
    fact = Table.from_data(fact_schema, {
        "fk": rng.integers(0, build_rows, num_rows, dtype=np.int32),
        "v": rng.random(num_rows, dtype=np.float32),
    }, device=device)
    dim = Table.from_data(dim_schema, {
        "pk": np.arange(build_rows, dtype=np.int32),
        "g": rng.integers(0, 64, build_rows, dtype=np.int32),
    }, device=device)
    plan = Sort(
        [SortKey("sv", ascending=False)],
        GroupAggregate(
            ["g"],
            [AggSpec(Aggregation.SUM, "v", "sv"),
             AggSpec(Aggregation.COUNT, None, "c")],
            HashJoin(JoinType.INNER, ["fk"], ["pk"],
                     Filter(col("v") > Const(0.5, DataType.FLOAT),
                            ScanTable(fact)),
                     ScanTable(dim), KeyUniqueness.UNIQUE),
            GroupAggregateOptions(estimated_result_row_count=64),
        ))
    run, _bound, leaves = compile_plan(plan)
    return run, leaves


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(leaves)`` runs one step and returns
    the raw tensors ``(sv values, num_rows, flags)``."""
    run, leaves = _make_pipeline(num_rows=8192, build_rows=1024,
                                 device=device)

    def fn(leaf_tables):
        table, flags, _names = run(leaf_tables)
        return table.columns["sv"].values, table.num_rows, flags

    return fn, (leaves,)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run and check the distributed pipeline over ``n_devices`` ranks
    (``parallel.dryrun``: in the caller's process group, or over ranks it
    spawns when there is none)."""
    from .parallel import dryrun

    dryrun(n_devices, device=device)


if __name__ == "__main__":
    import sys

    import torch

    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    fn, args = entry(dev)
    out = fn(*args)
    print("entry ok:", [tuple(torch.as_tensor(x).shape) for x in out])
    dryrun_multichip(max(torch.cuda.device_count(), 1)
                     if dev.startswith("cuda") else 2, dev)
    print("dryrun ok")
