"""Generate: N rows and no column (reference: cursor/core/generate.cc:53).
Port of ``supersonic_tpu/ops/generate.py``; a ``Compute`` of
``Sequence()`` over it makes data on the device.  The rows live on
``device``, the card unless the caller asks for another.
"""
from __future__ import annotations

from ..batch import Table
from ..schema import TupleSchema
from .base import BindContext, BoundOperation, Operation, RunContext


class Generate(Operation):
    def __init__(self, count: int, *, device="cuda"):
        self.count = count
        self.device = device

    def bind(self, ctx: BindContext) -> BoundOperation:
        schema = TupleSchema(())
        count, device = self.count, self.device

        def fn(rctx: RunContext) -> Table:
            return Table(schema, {}, count, device, {},
                         cap_hint=max(count, 1))

        return BoundOperation(schema, {}, fn, max(count, 1))
