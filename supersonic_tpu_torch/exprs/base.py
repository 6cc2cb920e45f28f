"""Expression engine core: symbolic trees, bind, evaluation on tensors.

Port of ``supersonic_tpu/exprs/base.py`` (reference: expression/base/
expression.h:42-158).  A bound expression is a function over (values,
valid) tensor pairs.  Only what the headline
predicate needs is ported: column references, constants and the six
comparisons; the other operators raise ``NotImplementedError`` (ROADMAP.md
queue 1 items 4 and 14).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import torch

from ..batch import Table
from ..dictionary import Dictionary
from ..schema import Attribute, TupleSchema
from ..types import DataType


class ExprValue(NamedTuple):
    """One evaluated column: values[capacity] + optional validity mask."""

    values: torch.Tensor
    valid: Optional[torch.Tensor]  # None => non-nullable / all valid


class EvaluationError(Exception):
    """Raised at the host sync when a device error flag is set (reference:
    ERROR_EVALUATION_ERROR)."""


@dataclass
class EvalContext:
    """Per-evaluation state threaded through the bound tree."""

    table: Table
    # (flag name, 0-d bool device tensor) pairs, read back by execute()
    error_flags: list = field(default_factory=list)


class BoundExpression:
    """A bound (typed, schema-resolved) expression node."""

    def __init__(self, attr: Attribute, fn: Callable[[EvalContext], ExprValue],
                 dictionary: Optional[Dictionary] = None,
                 is_constant: bool = False):
        self.attr = attr
        self._fn = fn
        self.dictionary = dictionary
        self.is_constant = is_constant

    @property
    def name(self) -> str:
        return self.attr.name

    @property
    def type(self) -> DataType:
        return self.attr.type

    @property
    def nullable(self) -> bool:
        return self.attr.nullable

    def evaluate(self, ctx: EvalContext) -> ExprValue:
        return self._fn(ctx)


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item 14: full "
        "expression engine)")


class Expression:
    """Symbolic expression node; ``bind`` resolves types against a schema."""

    def bind(self, schema: TupleSchema,
             dicts: Optional[dict] = None) -> BoundExpression:
        return self.do_bind(schema, dicts or {})

    def do_bind(self, schema: TupleSchema, dicts: dict) -> BoundExpression:
        raise NotImplementedError

    def as_(self, name: str) -> "Expression":
        return Alias(name, self)

    # -- sugar: comparisons are ported, the rest is not yet ------------------
    def __lt__(self, other):  from .comparison import Less; return Less(self, wrap(other))
    def __le__(self, other):  from .comparison import LessOrEqual; return LessOrEqual(self, wrap(other))
    def __gt__(self, other):  from .comparison import Greater; return Greater(self, wrap(other))
    def __ge__(self, other):  from .comparison import GreaterOrEqual; return GreaterOrEqual(self, wrap(other))
    def eq(self, other):      from .comparison import Equal; return Equal(self, wrap(other))
    def ne(self, other):      from .comparison import NotEqual; return NotEqual(self, wrap(other))

    def __add__(self, other): _not_ported("arithmetic")
    __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = __add__
    __truediv__ = __mod__ = __add__

    def __neg__(self): _not_ported("arithmetic")
    def __and__(self, other): _not_ported("logic")
    __or__ = __and__
    def __invert__(self): _not_ported("logic")


def wrap(value) -> Expression:
    """Lift a python literal to a Const expression."""
    if isinstance(value, Expression):
        return value
    from .terminal import Const
    return Const(value)


class Alias(Expression):
    def __init__(self, name: str, child: Expression):
        self.alias = name
        self.child = child

    def do_bind(self, schema, dicts):
        b = self.child.do_bind(schema, dicts)
        return BoundExpression(
            Attribute(self.alias, b.type, b.nullable, b.attr.enum),
            b.evaluate, b.dictionary, b.is_constant)


class NamedAttribute(Expression):
    """Column reference (reference: projecting_bound_expressions.h:40)."""

    def __init__(self, name: str):
        self.name = name

    def do_bind(self, schema, dicts):
        attr = schema.lookup(self.name)
        name = self.name

        def fn(ctx: EvalContext) -> ExprValue:
            c = ctx.table.columns[name]
            return ExprValue(c.values, c.valid)

        return BoundExpression(attr, fn, dicts.get(name))


def col(name: str) -> NamedAttribute:
    return NamedAttribute(name)


def merge_valid(*valids: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND of validity masks; None means 'all valid'."""
    present = [v for v in valids if v is not None]
    if not present:
        return None
    out = present[0]
    for v in present[1:]:
        out = out & v
    return out


def expr_name(op: str, children) -> str:
    return f"{op}({', '.join(c.name for c in children)})"
