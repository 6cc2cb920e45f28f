"""Operation test harness.

Port of ``supersonic_tpu/testing/operation_testing.py`` (reference:
testing/operation_testing.h:83-196 — the ``OperationTest`` fixture runs
every operator over a sweep of (input view size x output view size)
combinations so odd batch boundaries are exercised).

As in the JAX package, the boundary dimension is the capacity (padding) of
each input Table: ``check_operation`` re-executes the same plan with its
inputs padded to a sweep of capacities and asserts the same live rows, so
an operator that leaks padding rows into its result fails.  The tables are
built on ``device`` (the card unless the caller asks for the CPU, as the
tests do).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from ..batch import Table
from ..ops.base import Operation, execute
from ..ops.scan import ScanTable
from ..schema import TupleSchema

DEFAULT_SWEEP = (0, 1, 7, 2.0, 64)  # extra rows (int) or multiplier (float)


def sweep_capacities(n: int, sweep=DEFAULT_SWEEP) -> list[int]:
    caps = []
    for s in sweep:
        if isinstance(s, float):
            caps.append(max(int(n * s), 1))
        else:
            caps.append(max(n + s, 1))
    return sorted(set(caps))


def check_operation(plan_builder: Callable[..., Operation],
                    input_data: Sequence[tuple[TupleSchema, dict]],
                    expected: list[tuple],
                    ignore_row_order: bool = False,
                    sweep=DEFAULT_SWEEP, device="cuda") -> None:
    """Build + execute ``plan_builder(*tables)`` across a capacity sweep
    and compare live rows against ``expected`` (None = NULL).

    ``ignore_row_order`` mirrors OperationTest::SetIgnoreRowOrder
    (operation_testing.h:125).
    """
    max_rows = max((len(next(iter(d.values()))) if d else 0)
                   for _, d in input_data) if input_data else 0
    for cap in sweep_capacities(max_rows, sweep):
        tables = []
        for schema, data in input_data:
            n = len(next(iter(data.values()))) if data else 0
            tables.append(Table.from_data(schema, data,
                                          capacity=max(cap, n, 1),
                                          device=device))
        got = execute(plan_builder(*tables)).to_pylist()
        if ignore_row_order:
            assert sorted(got, key=repr) == sorted(expected, key=repr), \
                f"capacity={cap}: {got} != {expected}"
        else:
            assert got == expected, f"capacity={cap}: {got} != {expected}"


class OperationTest:
    """Fixture-style wrapper mirroring the reference's OperationTest usage:

        t = OperationTest(device="cpu")
        t.add_input(schema, data)
        t.set_expected_result(rows)
        t.execute(lambda *inputs: Filter(..., inputs[0]))
    """

    def __init__(self, device="cuda"):
        self.inputs: list[tuple[TupleSchema, dict]] = []
        self.expected: Optional[list[tuple]] = None
        self.ignore_row_order = False
        self.device = device

    def add_input(self, schema: TupleSchema, data: dict) -> None:
        self.inputs.append((schema, data))

    def set_expected_result(self, rows: list[tuple]) -> None:
        self.expected = rows

    def set_ignore_row_order(self, v: bool = True) -> None:
        self.ignore_row_order = v

    def execute(self, plan_builder) -> None:
        assert self.expected is not None, "set_expected_result first"
        check_operation(
            lambda *tables: plan_builder(*[ScanTable(t) for t in tables]),
            self.inputs, self.expected, self.ignore_row_order,
            device=self.device)
