"""Project: column subset / reorder / rename, zero-copy.

Port of ``supersonic_tpu/ops/project.py`` (reference: cursor/core/
project.cc:41, base/infrastructure/projector.h:188-422).  A projection is
metadata only: the output Table references the same tensors.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

from ..batch import Table
from ..schema import Attribute, TupleSchema
from .base import BindContext, BoundOperation, Operation, RunContext


class Projector:
    """Single-source projector: ordered (source, output name) pairs.

    Reference: ProjectNamedAttribute / ProjectAttributeAt /
    ProjectAllAttributes / ProjectRename (projector.h:363-405).
    """

    def __init__(self, items: Sequence[tuple[Union[str, int], Optional[str]]]):
        # items: (source name or position, output name or None=keep)
        self.items = list(items)

    @staticmethod
    def named(*names: str) -> "Projector":
        return Projector([(n, None) for n in names])

    @staticmethod
    def at(*positions: int) -> "Projector":
        return Projector([(p, None) for p in positions])

    @staticmethod
    def all() -> "Projector":
        return Projector([("*", None)])

    @staticmethod
    def rename(mapping: dict[str, str]) -> "Projector":
        return Projector([(src, dst) for src, dst in mapping.items()])

    def resolve(self, schema: TupleSchema) -> list[tuple[str, str]]:
        """-> [(source_name, output_name)] with '*' expanded."""
        out = []
        for src, dst in self.items:
            if src == "*":
                out.extend((a.name, a.name) for a in schema)
            elif isinstance(src, int):
                name = schema.attribute(src).name
                out.append((name, dst or name))
            else:
                schema.lookup_position(src)  # existence check
                out.append((src, dst or src))
        return out


class Project(Operation):
    def __init__(self, projector: Projector, child: Operation):
        self.projector = projector
        self.child = child

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        pairs = self.projector.resolve(cb.schema)
        attrs = []
        for src, dst in pairs:
            a = cb.schema.lookup(src)
            attrs.append(Attribute(dst, a.type, a.nullable, a.enum))
        schema = TupleSchema(attrs)  # raises on duplicate output names
        dicts = {dst: cb.dicts[src] for src, dst in pairs if src in cb.dicts}

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            cols = {dst: t.columns[src] for src, dst in pairs}
            return Table(schema, cols, t.num_rows, t.device, dicts,
                         cap_hint=t.capacity)

        stats = {dst: cb.stats[src] for src, dst in pairs if src in cb.stats}
        # zero-copy projection keeps row positions, so row-id keys survive
        rowid = {dst for src, dst in pairs if src in cb.rowid}
        return BoundOperation(schema, dicts, fn, cb.capacity, stats=stats,
                              rowid=rowid)
