"""Expression engine core: symbolic trees, bind, evaluation on tensors.

Port of ``supersonic_tpu/exprs/base.py`` (reference: expression/base/
expression.h:42-158).  A bound expression is a function over (values,
valid) tensor pairs, run eagerly.  Both branches of a conditional are
computed and merged with masks, and signaling error policies become device
error flags read back at the plan's one host sync.  A string-producing
expression over an unbounded value space (ToString, Format, DateFormat
without a domain) registers a ``DeferredRender``: the device column holds
row-position codes and ``execute`` renders the strings after the run
(ops/host.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

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
    # host rendering records (DeferredRender), resolved by execute() after
    # the flags' host sync
    deferred: list = field(default_factory=list)
    # (tag, id(tensor)) -> (tensor, result): work that several expressions
    # of one evaluation derive from the same tensor, done once (``memo``)
    memo: dict = field(default_factory=dict)

    def flag_error(self, name: str, per_row_flag: torch.Tensor) -> None:
        """Raise ``name`` at the host sync if a live row sets the flag."""
        live = per_row_flag & self.table.row_mask()
        self.error_flags.append((name, live.any()))

    def defer(self, entry) -> None:
        self.deferred.append(entry)

    def memo_of(self, tag, tensor: torch.Tensor, compute):
        """``compute()`` for ``tensor`` under ``tag``, once an evaluation:
        the entry holds the tensor, so its id names it while it lives."""
        key = (tag, id(tensor))
        hit = self.memo.get(key)
        if hit is None or hit[0] is not tensor:
            hit = self.memo[key] = (tensor, compute())
        return hit[1]


@dataclass
class DeferredRender:
    """Host rendering of a string-producing expression whose value space
    is unbounded (ToString, Format or DateFormat without a domain; the
    reference renders per row, types_infrastructure.h:464-506,
    math_evaluators.h:39-59, date_evaluators.cc:227-265).

    The device column carries ROW-POSITION codes into a
    DeferredDictionary; ``aux`` holds the numeric values and the render
    mask, which ``execute`` reads back to render the strings after the
    run (ops/host.py::resolve_deferred).  The codes survive any later row
    movement (they index the dictionary, not the table) but are not
    order-preserving, so such a column is rejected as a sort, group or
    join key (ops/keys.py)."""

    name: str
    dict_obj: object            # DeferredDictionary made at bind
    kind: str                   # "tostring" | "format" | "dateformat"
    input_type: object          # DataType of the numeric input
    fmt: object = None          # strftime format (dateformat)
    precision: int = 0          # %.*f precision (format)
    aux: dict = None            # tensors: vals, ok


def defer_render(ctx: EvalContext, dict_obj, name: str, kind: str,
                 input_type, vals, ok, fmt=None, precision: int = 0):
    """Register a deferred-rendered STRING column on ``ctx`` and return its
    row-position codes.  ``dict_obj`` is the DeferredDictionary made at
    bind (a re-evaluation resolves it again)."""
    ctx.defer(DeferredRender(name=name, dict_obj=dict_obj, kind=kind,
                             input_type=input_type, fmt=fmt,
                             precision=precision,
                             aux={"vals": vals, "ok": ok}))
    return torch.arange(vals.shape[0], dtype=torch.int32,
                        device=vals.device)


class BoundExpression:
    """A bound (typed, schema-resolved) expression node.  ``is_constant``
    marks a ``Const`` (the JAX package's meaning); ``foldable`` also marks
    an expression that ``fold_constants`` made of constants."""

    def __init__(self, attr: Attribute, fn: Callable[[EvalContext], ExprValue],
                 dictionary: Optional[Dictionary] = None,
                 is_constant: bool = False):
        self.attr = attr
        self._fn = fn
        self.dictionary = dictionary
        self.is_constant = is_constant
        self.foldable = is_constant

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
        out = BoundExpression(
            Attribute(self.alias, b.type, b.nullable, b.attr.enum),
            b.evaluate, b.dictionary, b.is_constant)
        out.foldable = b.foldable
        return out


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


class AttributeAt(Expression):
    """Positional column reference (reference: projector.h:376
    ProjectAttributeAt)."""

    def __init__(self, position: int):
        self.position = position

    def do_bind(self, schema, dicts):
        attr = schema.attribute(self.position)
        return NamedAttribute(attr.name).do_bind(schema, dicts)


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


def fold_constants(bound: BoundExpression,
                   children: Sequence[BoundExpression]) -> BoundExpression:
    """``bound`` evaluated once a run on one row, then broadcast to the
    capacity, when every child is a constant (or folded): an eager
    evaluation would otherwise compute it over every row (the JAX
    package's compiled programs fold such subtrees).  A constant's error
    flag is the same on every row, so the one row's flag counts where the
    table has a live row.  Expressions that defer work (ToString, Format,
    DateFormat without a domain) are never folded."""
    if not children or not all(c.foldable for c in children):
        return bound
    inner = bound.evaluate

    def fn(ctx: EvalContext) -> ExprValue:
        one = Table(TupleSchema([]), {}, 1, ctx.table.device, cap_hint=1)
        sub = EvalContext(one)
        v = inner(sub)
        live = ctx.table.num_rows > 0  # a bool or a 0-d device tensor
        ctx.error_flags.extend((name, f & live)
                               for name, f in sub.error_flags)
        cap = ctx.table.capacity
        return ExprValue(v.values.expand(cap).contiguous(),
                         None if v.valid is None
                         else v.valid.expand(cap).contiguous())

    out = BoundExpression(bound.attr, fn, bound.dictionary)
    out.foldable = True
    return out


def expr_name(op: str, children) -> str:
    return f"{op}({', '.join(c.name for c in children)})"


def InputAttributeProjection(projector):
    """Expressions projecting the input through a single-source projector
    (reference: projecting_expressions.h:46): an ``ops.project.Projector``,
    an attribute name or a sequence of names; one Expression per projected
    attribute (a bare Expression for one)."""
    if isinstance(projector, str):
        return NamedAttribute(projector)
    if isinstance(projector, (list, tuple)):
        return [NamedAttribute(n) for n in projector]
    exprs = []
    for src, dst in projector.items:
        e = (AttributeAt(src) if isinstance(src, int)
             else NamedAttribute(src))
        exprs.append(e if dst is None else Alias(dst, e))
    return exprs[0] if len(exprs) == 1 else exprs


def Projection(sources, projector):
    """Rename or reorder sub-expressions through a projector (reference:
    projecting_expressions.h:71-74): positional entries select from
    ``sources``, named ones rename by output name."""
    sources = list(sources)
    out = []
    for src, dst in projector.items:
        e = sources[src] if isinstance(src, int) else NamedAttribute(src)
        out.append(e if dst is None else Alias(dst, e))
    return out[0] if len(out) == 1 else out
