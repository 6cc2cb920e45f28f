"""Plan sharing, spying and ownership (reference counterparts: Splitter,
cursor/core/splitter.h:53-330; SpyCursor, cursor/core/spy.h:30-48;
OwnershipTaker, cursor/core/ownership_taker.h).

Port of ``supersonic_tpu/ops/misc.py``.  ``SharedOperation`` binds its
subtree once and runs it once per execution, through a cache on the
``RunContext``.  ``Spy`` reports each execution's row count to its
listener; the JAX package does so through a ``jax.debug.callback`` inside
the program, and the port after ``execute``'s one host sync, whose
transfer carries every Spy's count beside the error flags, so a Spy adds
no sync of its own.
"""
from __future__ import annotations

from typing import Optional

from .. import tracing
from ..batch import Table
from .base import BindContext, BoundOperation, Operation, RunContext


class SharedOperation(Operation):
    """One subtree shared by several consumers (the Splitter analogue)."""

    def __init__(self, child: Operation):
        self.child = child
        self._bound_for: Optional[BindContext] = None
        self._bound: Optional[BoundOperation] = None

    def bind(self, ctx: BindContext) -> BoundOperation:
        if self._bound_for is not ctx:
            cb = self.child.bind(ctx)
            cache_key = ("shared", id(self))

            def fn(rctx: RunContext) -> Table:
                cache = rctx.__dict__.setdefault("_shared_cache", {})
                if cache_key not in cache:
                    cache[cache_key] = cb.run(rctx)
                return cache[cache_key]

            self._bound_for = ctx
            self._bound = BoundOperation(cb.schema, cb.dicts, fn,
                                         cb.capacity)
        return self._bound


class SpyListener:
    """reference: SpyListener (spy.h:30)."""

    def on_result(self, name: str, num_rows) -> None:  # pragma: no cover
        print(f"[spy {name}] rows={num_rows}")


class Spy(Operation):
    """Reports each execution's output row count to ``listener``, after
    ``execute``'s host sync."""

    def __init__(self, name: str, child: Operation,
                 listener: Optional[SpyListener] = None):
        self.name = name
        self.child = child
        self.listener = listener or SpyListener()

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        name, listener = self.name, self.listener

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            rctx.spies.append((listener, name, t.num_rows))
            return t

        return BoundOperation(cb.schema, cb.dicts, fn, cb.capacity)


class TakeOwnership(Operation):
    """Ties the lifetime of any owned objects to a plan node (reference:
    ownership_taker.h TakeOwnership)."""

    def __init__(self, child: Operation, *owned):
        self.child = child
        self._owned = owned  # kept alive by the plan

    def bind(self, ctx: BindContext) -> BoundOperation:
        return self.child.bind(ctx)


def format_table(table: Table, limit: int = 20) -> str:
    """The live rows, as text (reference: ViewPrinter,
    cursor/infrastructure/view_printer.h)."""
    names = table.schema.names()
    rows = table.to_pylist()[:limit]
    widths = [max(len(n), *(len(repr(r[i])) for r in rows)) if rows
              else len(n) for i, n in enumerate(names)]
    header = " | ".join(n.ljust(w) for n, w in zip(names, widths))
    sep = "-+-".join("-" * w for w in widths)
    body = "\n".join(" | ".join(repr(v).ljust(w) for v, w in zip(r, widths))
                     for r in rows)
    total = int(tracing.to_host(table.num_rows, "copy.num_rows"))
    suffix = "" if total <= limit else f"\n... ({total - limit} more rows)"
    return f"{header}\n{sep}\n{body}{suffix}"
