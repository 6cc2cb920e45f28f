"""Operation layer: operator DAGs bound once, then run eagerly on tensors.

Port of ``supersonic_tpu/ops/base.py`` (reference: cursor/base/
operation.h:35).  ``bind()`` resolves schemas bottom-up and yields a
function over whole capacity-padded Tables; ``execute()`` runs it.  There
is no jit: PyTorch launches each operation as the function reaches it.
Device-side error flags (0-d bool tensors) are collected while the plan
runs and read back in ONE host sync at the end of ``execute``, which
raises ``EvaluationError`` naming every flag that fired, with the same
names as the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..batch import Table
from ..exprs.base import EvalContext, EvaluationError
from ..schema import TupleSchema


class Interrupted(RuntimeError):
    """Raised when a query is cooperatively cancelled (reference:
    ``Cursor::Interrupt``, cursor/base/cursor.h:160-166)."""


class CancellationToken:
    """Cooperative cancellation, polled at ``execute()`` entry and before
    the plan runs.  Call ``interrupt()`` from any thread."""

    __slots__ = ("_interrupted",)

    def __init__(self):
        self._interrupted = False

    def interrupt(self) -> None:
        self._interrupted = True

    def interrupted(self) -> bool:
        return self._interrupted

    def check(self) -> None:
        if self._interrupted:
            raise Interrupted("query interrupted")


@dataclass
class RunContext:
    """Execution-time state threaded through the bound DAG."""

    leaf_tables: list  # Tables for each leaf, in bind order
    # (flag name, 0-d bool device tensor) pairs
    error_flags: list = field(default_factory=list)
    cancel: Optional[CancellationToken] = None

    def eval_context(self, table: Table) -> EvalContext:
        return EvalContext(table, self.error_flags)


@dataclass
class BoundOperation:
    """Result of binding: static schema/dicts + a table function.

    ``stats`` holds planner statistics, per-column (min, max) bounds known
    at bind time; ``rowid`` the columns whose value is the row position
    plus ``stats[name][0]``.
    Plans chosen from them add a runtime guard flag, since a bound plan may
    be re-run on other data of the same shapes.
    """

    schema: TupleSchema
    dicts: dict
    fn: Callable[[RunContext], Table]
    capacity: int
    stats: dict = field(default_factory=dict)
    rowid: set = field(default_factory=set)

    def run(self, ctx: RunContext):
        return self.fn(ctx)


class BindContext:
    """Collects leaf inputs during bind."""

    def __init__(self, cancel: Optional[CancellationToken] = None):
        self.leaves: list[Table] = []
        self.cancel = cancel

    def register_leaf(self, table: Table) -> int:
        self.leaves.append(table)
        return len(self.leaves) - 1


class Operation:
    """Symbolic operator-DAG node (reference: cursor/base/operation.h:35)."""

    def bind(self, ctx: BindContext) -> BoundOperation:
        raise NotImplementedError

    def execute(self, check_errors: bool = True,
                cancel: Optional[CancellationToken] = None) -> Table:
        return execute(self, check_errors=check_errors, cancel=cancel)


def compile_plan(op: Operation, cancel: Optional[CancellationToken] = None):
    """Bind a plan: returns (run, bound, leaves), where
    ``run(leaf_tables) -> (Table, flags, names)``: ``flags`` is a bool
    tensor with one entry per error flag, ``names`` their names.  ``run``
    is reusable over other leaf tables of the same shapes."""
    bctx = BindContext(cancel=cancel)
    bound = op.bind(bctx)

    def run(leaf_tables):
        ctx = RunContext(list(leaf_tables), cancel=cancel)
        out = bound.run(ctx)
        names = [n for n, _ in ctx.error_flags]
        if ctx.error_flags:
            flags = torch.stack([f.reshape(()) for _, f in ctx.error_flags])
        else:
            flags = torch.zeros(0, dtype=torch.bool)
        return out, flags, names

    return run, bound, bctx.leaves


def raise_flags(flags: torch.Tensor, names: list) -> None:
    """The host sync: read the flags back and raise EvaluationError for
    every one that fired ("warning:" flags only warn)."""
    if not names:
        return
    host = flags.cpu().tolist()
    raised = [n for n, f in zip(names, host) if f]
    for w in raised:
        if w.startswith("warning:"):
            import warnings

            warnings.warn(w, RuntimeWarning, stacklevel=3)
    bad = [n for n in raised if not n.startswith("warning:")]
    if bad:
        raise EvaluationError(f"evaluation failed: {', '.join(bad)}")


def execute(op: Operation, check_errors: bool = True,
            cancel: Optional[CancellationToken] = None) -> Table:
    """Bind and run a plan; raises EvaluationError when a device error flag
    fired (one host sync, at the end)."""
    if cancel is not None:
        cancel.check()
    run, _bound, leaves = compile_plan(op, cancel=cancel)
    if cancel is not None:
        cancel.check()
    table, flags, names = run(leaves)
    if check_errors:
        raise_flags(flags, names)
    return table


def not_ported(what: str, item: str):
    """Raise for a part of the JAX package the port does not cover yet."""
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item {item})")
