"""Operation layer: operator DAGs bound once, then run eagerly on tensors.

Port of ``supersonic_tpu/ops/base.py`` (reference: cursor/base/
operation.h:35).  ``bind()`` resolves schemas bottom-up and yields a
function over whole capacity-padded Tables; ``execute()`` runs it.  There
is no jit: PyTorch launches each operation as the function reaches it.
Device-side error flags (0-d bool tensors) are collected while the plan
runs and read back in ONE host sync at the end of ``execute``, which
raises ``EvaluationError`` naming every flag that fired, with the same
names as the JAX package.  The row counts that ``Spy`` nodes report ride
the same transfer.  After it, ``execute`` resolves the deferred host work
the plan registered (``RunContext.deferred``: the byte assembly of CONCAT
aggregates, ops/host.py).

Host and disk boundaries (the external sort of ``SortWithTempDirPrefix``,
``HybridGroupAggregate``'s spill) register a lazy leaf at bind: a
placeholder table fixes the schema and capacity, and its producer runs in
``prepare_leaves``, before the plan runs, so bind stays free of side
effects (the reference's hybrid cursor drains its child at the first
``Next()``, aggregate_groups.cc:332-431).  The JAX package's compiled
program caches exist for its remote compile and have no counterpart: a
``compile_plan`` run is reused over same-shaped leaves as it is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from .. import tracing
from ..batch import Column, Table
from ..exprs.base import EvalContext, EvaluationError
from ..schema import TupleSchema
from ..types import torch_dtype


class Interrupted(RuntimeError):
    """Raised when a query is cooperatively cancelled (reference:
    ``Cursor::Interrupt``, cursor/base/cursor.h:160-166)."""


class CancellationToken:
    """Cooperative in-flight cancellation.

    The reference propagates ``Interrupt()`` down the cursor tree and
    cursors poll the flag inside their ``Next()`` loops.  Here one eager
    run of a bound plan is not split, so the poll points are the host
    boundaries, as in the JAX package: ``execute()`` entry, every chunk of
    the external (spill) sort and the hybrid aggregation's pregroup and
    combine loops, and each deferred host-materialisation item.  Every
    poll goes through ``interrupted()``, so a subclass may read an outside
    flag there (a deadline, a client hang-up).  Call ``interrupt()`` from
    any thread; the query raises ``Interrupted`` at its next poll point.
    """

    __slots__ = ("_interrupted",)

    def __init__(self):
        self._interrupted = False

    def interrupt(self) -> None:
        self._interrupted = True

    def interrupted(self) -> bool:
        return self._interrupted

    def check(self) -> None:
        if self.interrupted():
            raise Interrupted("query interrupted")


@dataclass
class RunContext:
    """Execution-time state threaded through the bound DAG."""

    leaf_tables: list  # Tables for each leaf, in bind order
    # (flag name, 0-d bool device tensor) pairs
    error_flags: list = field(default_factory=list)
    cancel: Optional[CancellationToken] = None
    # host work resolved after the run (DeferredConcat and DeferredRender
    # records whose aux tensors execute() reads back;
    # ops/host.py::resolve_deferred)
    deferred: list = field(default_factory=list)
    # (listener, name, row count) of each Spy that ran, reported after the
    # flags' host sync
    spies: list = field(default_factory=list)

    def eval_context(self, table: Table) -> EvalContext:
        return EvalContext(table, self.error_flags, self.deferred)


@dataclass
class BoundOperation:
    """Result of binding: static schema/dicts + a table function.

    ``stats`` holds planner statistics, per-column (min, max) bounds known
    at bind time; ``rowid`` the columns whose value is the row position
    plus ``stats[name][0]``.
    Plans chosen from them add a runtime guard flag, since a bound plan may
    be re-run on other data of the same shapes.
    ``name`` is the class of the operator that bound it, ``route`` the
    path its bind chose where it chooses one (a join's probe, a group-by's
    aggregation); the node's run span carries both.  ``timed`` False marks
    a node whose run launches no device work (a leaf handing over its
    table), which the run span then does not time on the device.
    """

    schema: TupleSchema
    dicts: dict
    fn: Callable[[RunContext], Table]
    capacity: int
    stats: dict = field(default_factory=dict)
    rowid: set = field(default_factory=set)
    name: Optional[str] = None
    route: Optional[str] = None
    timed: bool = True

    def run(self, ctx: RunContext):
        with tracing.node(self, ctx):
            out = self.fn(ctx)
        # a masked bind returns (Table, keep): the table part is checked
        if _DEBUG_CHECKS:
            _append_debug_checks(out[0] if isinstance(out, tuple) else out,
                                 ctx)
        return out


# DCHECK-style validation of every operator output (reference: block.h:
# 91-94, cursor.h:114-117); off by default, raised through the flags' sync
_DEBUG_CHECKS = False


def set_debug_checks(enabled: bool) -> None:
    """Check every operator's output on the device (its row count within
    its capacity, its dictionary codes within their dictionaries) and
    raise through the flags' host sync; costs device work a node."""
    global _DEBUG_CHECKS
    _DEBUG_CHECKS = bool(enabled)


def _append_debug_checks(table: Table, ctx: RunContext) -> None:
    n = torch.as_tensor(table.num_rows, device=table.device)
    ctx.error_flags.append(("debug: num_rows out of [0, capacity]",
                            (n < 0) | (n > table.capacity)))
    live = table.row_mask()
    for name, d in table.dicts.items():
        if name not in table.columns:
            continue
        c = table.columns[name]
        ok = live if c.valid is None else (live & c.valid)
        bad = ok & ((c.values < 0) | (c.values >= max(len(d), 1)))
        ctx.error_flags.append(
            (f"debug: dictionary code out of range in {name!r}", bad.any()))


class BindContext:
    """Collects leaf inputs during bind, and the lazy leaves of host and
    disk boundaries: (leaf index, producer) pairs resolved by
    ``prepare_leaves`` when the plan runs."""

    def __init__(self, cancel: Optional[CancellationToken] = None):
        self.leaves: list[Table] = []
        self.lazy: list = []
        self.cancel = cancel

    def check_cancel(self) -> None:
        """Poll point for host and disk boundaries that run while the plan
        binds."""
        if self.cancel is not None:
            self.cancel.check()

    def register_leaf(self, table: Table) -> int:
        self.leaves.append(table)
        return len(self.leaves) - 1

    def register_lazy_leaf(self, placeholder: Table, producer) -> int:
        """Register a host-produced leaf: ``placeholder`` fixes its schema
        and capacity at bind; ``producer(leaves, cancel) -> Table`` runs in
        ``prepare_leaves`` and returns a table of the placeholder's
        capacity and columns."""
        idx = self.register_leaf(placeholder)
        self.lazy.append((idx, producer))
        return idx


def placeholder(schema: TupleSchema, capacity: int, dicts: dict) -> Table:
    """A lazy leaf's stand-in until its producer runs: no rows, and
    ``capacity`` rows of broadcast zeros that allocate nothing."""
    def lane(dtype):
        return torch.zeros(1, dtype=dtype).expand(capacity)

    cols = {a.name: Column(lane(torch_dtype(a.type)),
                           lane(torch.bool) if a.nullable else None)
            for a in schema}
    return Table(schema, cols, 0, "cpu", dict(dicts), cap_hint=capacity)


def prepare_leaves(leaves, lazy, cancel=None) -> list:
    """Resolve the lazy leaves before the run, in bind order: a producer
    sees the leaves resolved before it (a spill below a spill)."""
    leaves = list(leaves)
    with tracing.span("query.prepare"):
        for idx, producer in lazy:
            leaves[idx] = producer(leaves, cancel)
    return leaves


class Operation:
    """Symbolic operator-DAG node (reference: cursor/base/operation.h:35).

    Every subclass's own ``bind`` is wrapped once, where the class is
    made: its span ``op.<Class>.bind`` and the class's name on the bound
    operator (``tracing.traced_bind``)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "bind" in cls.__dict__:
            cls.bind = tracing.traced_bind(cls.__dict__["bind"])

    def bind(self, ctx: BindContext) -> BoundOperation:
        raise NotImplementedError

    def execute(self, check_errors: bool = True,
                cancel: Optional[CancellationToken] = None) -> Table:
        return execute(self, check_errors=check_errors, cancel=cancel)


def bind_plan(op: Operation, cancel: Optional[CancellationToken] = None):
    """Bind a plan: (BoundOperation, its leaf tables)."""
    ctx = BindContext(cancel=cancel)
    bound = op.bind(ctx)
    return bound, ctx.leaves


def compile_plan(op: Operation, cancel: Optional[CancellationToken] = None):
    """Bind a plan: returns (run, bound, leaves), where
    ``run(leaf_tables) -> (Table, flags, names)``: ``flags`` is a bool
    tensor with one entry per error flag, ``names`` their names.  ``run``
    is reusable over other leaf tables of the same shapes; after each call
    ``run.deferred`` and ``run.spies`` hold that run's deferred host work
    and Spy reports (``finish`` takes them).  ``run.lazy`` holds the lazy
    leaves, which ``prepare_leaves`` resolves before a run."""
    with tracing.span("query.bind", new_query=True):
        bctx = BindContext(cancel=cancel)
        bound = op.bind(bctx)
        run = _runner(bound, cancel)
        run.lazy = bctx.lazy
    return run, bound, bctx.leaves


def _runner(bound: BoundOperation, cancel: Optional[CancellationToken]):
    def run(leaf_tables):
        with tracing.span("query.run"):
            ctx = RunContext(list(leaf_tables), cancel=cancel)
            out = bound.run(ctx)
            names = [n for n, _ in ctx.error_flags]
            if ctx.error_flags:
                flags = torch.stack([f.reshape(())
                                     for _, f in ctx.error_flags])
            else:
                flags = torch.zeros(0, dtype=torch.bool)
        run.deferred, run.spies = list(ctx.deferred), list(ctx.spies)
        return out, flags, names

    run.deferred, run.spies, run.lazy = [], [], []
    return run


def raise_flags(flags: torch.Tensor, names: list, spies=(),
                warn: bool = True) -> None:
    """The host sync: read the flags (and the row counts of ``spies``)
    back in one transfer, report each Spy's count to its listener, and
    raise EvaluationError for every flag that fired ("warning:" flags only
    warn, and only with ``warn``)."""
    counts = [n for _, _, n in spies if not isinstance(n, int)]
    host = []
    if counts:
        dev = counts[0].device
        host = tracing.to_host(
            torch.cat([flags.to(dev, torch.int64)]
                      + [c.reshape(1).to(torch.int64) for c in counts]),
            "flags").tolist()
    elif names:
        host = tracing.to_host(flags, "flags").tolist()
    it = iter(host[len(names):])
    for listener, name, n in spies:
        listener.on_result(name, n if isinstance(n, int) else next(it))
    raised = [n for n, f in zip(names, host) if f]
    for w in raised if warn else ():
        if w.startswith("warning:"):
            import warnings

            warnings.warn(w, RuntimeWarning, stacklevel=3)
    bad = [n for n in raised if not n.startswith("warning:")]
    if bad:
        raise EvaluationError(f"evaluation failed: {', '.join(bad)}")


def execute(op: Operation, check_errors: bool = True,
            cancel: Optional[CancellationToken] = None) -> Table:
    """Bind and run a plan; raises EvaluationError when a device error flag
    fired (one host sync, at the end).  Lazy leaves (host and disk
    boundaries) resolve before the run."""
    if cancel is not None:
        cancel.check()
    run, _bound, leaves = compile_plan(op, cancel=cancel)
    if cancel is not None:
        cancel.check()
    leaves = prepare_leaves(leaves, run.lazy, cancel)
    table, flags, names = run(leaves)
    finish(run, flags, names, check_errors, cancel)
    return table


def finish(run, flags, names, check_errors: bool = True,
           cancel: Optional[CancellationToken] = None) -> None:
    """What ``execute`` does after the run of ``compile_plan``'s ``run``:
    the one host sync of the flags and Spy counts, then the deferred host
    work (CONCAT byte assembly)."""
    with tracing.span("query.finish"):
        if not check_errors:
            flags, names = flags[:0], []
        raise_flags(flags, names, run.spies)
        if run.deferred:
            from .host import resolve_deferred

            resolve_deferred(run.deferred, cancel=cancel)


def materialize_bound(bound: BoundOperation, leaf_tables,
                      cancel: Optional[CancellationToken] = None) -> Table:
    """Run a subtree that is already bound on resolved leaf tables: the
    producer side of a host or disk boundary (``register_lazy_leaf``),
    whose child bound once in the real BindContext.  Raises for its error
    flags and resolves its deferred host work."""
    run = _runner(bound, cancel)
    table, flags, names = run(list(leaf_tables))
    raise_flags(flags, names, run.spies, warn=False)
    if run.deferred:
        from .host import resolve_deferred

        resolve_deferred(run.deferred, cancel=cancel)
    return table


def materialize_child(op: Operation) -> Table:
    """Bind a subtree once and run it to a concrete Table: the
    materialization boundary of host and disk operators (as HashJoin's
    build drains its rhs in the reference, hash_join.cc:604).  Raises for
    its error flags."""
    run, _bound, leaves = compile_plan(op)
    leaves = prepare_leaves(leaves, run.lazy)
    table, flags, names = run(leaves)
    raise_flags(flags, names, run.spies, warn=False)
    if run.deferred:
        from .host import resolve_deferred

        resolve_deferred(run.deferred)
    return table
