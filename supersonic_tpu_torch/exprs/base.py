"""Expression engine core: symbolic trees, bind, evaluation on tensors.

Port of ``supersonic_tpu/exprs/base.py`` (reference: expression/base/
expression.h:42-158).  A bound expression is a function over (values,
valid) tensor pairs.  Ported so far: column references, constants,
``Sequence`` and ``Null``, the comparisons, arithmetic, logic, ``IsNull``
and ``IfNull``; the rest of the engine is ROADMAP.md queue 1 item 14.
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

    def valid_or_true(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.values.shape[0], dtype=torch.bool,
                              device=self.values.device)
        return self.valid


class EvaluationError(Exception):
    """Raised at the host sync when a device error flag is set (reference:
    ERROR_EVALUATION_ERROR)."""


@dataclass
class EvalContext:
    """Per-evaluation state threaded through the bound tree."""

    table: Table
    # (flag name, 0-d bool device tensor) pairs, read back by execute()
    error_flags: list = field(default_factory=list)

    def flag_error(self, name: str, per_row_flag: torch.Tensor) -> None:
        """Raise ``name`` at the host sync if a live row sets the flag."""
        live = per_row_flag & self.table.row_mask()
        self.error_flags.append((name, live.any()))


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


class Expression:
    """Symbolic expression node; ``bind`` resolves types against a schema."""

    def bind(self, schema: TupleSchema,
             dicts: Optional[dict] = None) -> BoundExpression:
        return self.do_bind(schema, dicts or {})

    def do_bind(self, schema: TupleSchema, dicts: dict) -> BoundExpression:
        raise NotImplementedError

    def as_(self, name: str) -> "Expression":
        return Alias(name, self)

    # -- sugar ----------------------------------------------------------------
    def __add__(self, other):  from .arithmetic import Plus; return Plus(self, wrap(other))
    def __radd__(self, other): from .arithmetic import Plus; return Plus(wrap(other), self)
    def __sub__(self, other):  from .arithmetic import Minus; return Minus(self, wrap(other))
    def __rsub__(self, other): from .arithmetic import Minus; return Minus(wrap(other), self)
    def __mul__(self, other):  from .arithmetic import Multiply; return Multiply(self, wrap(other))
    def __rmul__(self, other): from .arithmetic import Multiply; return Multiply(wrap(other), self)
    def __truediv__(self, other): from .arithmetic import DivideSignaling; return DivideSignaling(self, wrap(other))
    def __mod__(self, other):  from .arithmetic import ModulusSignaling; return ModulusSignaling(self, wrap(other))
    def __neg__(self):         from .arithmetic import Negate; return Negate(self)
    def __lt__(self, other):   from .comparison import Less; return Less(self, wrap(other))
    def __le__(self, other):   from .comparison import LessOrEqual; return LessOrEqual(self, wrap(other))
    def __gt__(self, other):   from .comparison import Greater; return Greater(self, wrap(other))
    def __ge__(self, other):   from .comparison import GreaterOrEqual; return GreaterOrEqual(self, wrap(other))
    def __and__(self, other):  from .logic import And; return And(self, wrap(other))
    def __or__(self, other):   from .logic import Or; return Or(self, wrap(other))
    def __invert__(self):      from .logic import Not; return Not(self)
    def eq(self, other):       from .comparison import Equal; return Equal(self, wrap(other))
    def ne(self, other):       from .comparison import NotEqual; return NotEqual(self, wrap(other))


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
