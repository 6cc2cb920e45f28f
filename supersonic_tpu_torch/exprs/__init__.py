"""Expression factories of the port (the slice: columns, constants,
comparisons)."""
from .base import (Alias, BoundExpression, EvalContext, EvaluationError,
                   Expression, ExprValue, NamedAttribute, col)
from .comparison import (Equal, Greater, GreaterOrEqual, Less, LessOrEqual,
                         NotEqual)
from .terminal import (Const, ConstBool, ConstDouble, ConstFloat, ConstInt32,
                       ConstInt64, TypedConst)

__all__ = [
    "Alias", "BoundExpression", "Const", "ConstBool", "ConstDouble",
    "ConstFloat", "ConstInt32", "ConstInt64", "Equal", "EvalContext",
    "EvaluationError", "Expression", "ExprValue", "Greater",
    "GreaterOrEqual", "Less", "LessOrEqual", "NamedAttribute", "NotEqual",
    "TypedConst", "col",
]
