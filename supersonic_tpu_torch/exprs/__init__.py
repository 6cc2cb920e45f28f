"""Expression factories of the port (columns, constants, ``Sequence`` and
``Null``, comparisons, arithmetic, logic, ``IsNull`` and ``IfNull``)."""
from .base import (Alias, BoundExpression, EvalContext, EvaluationError,
                   Expression, ExprValue, NamedAttribute, col)
from .terminal import (Const, ConstBool, ConstDouble, ConstFloat, ConstInt32,
                       ConstInt64, Null, Sequence, TypedConst)
from .arithmetic import (CppDivide, CppDivideNulling, CppDivideSignaling,
                         Divide, DivideNulling, DivideQuiet, DivideSignaling,
                         Minus, Modulus, ModulusNulling, ModulusSignaling,
                         Multiply, Negate, Plus)
from .comparison import (Equal, Greater, GreaterOrEqual, Less, LessOrEqual,
                         NotEqual)
from .logic import (And, AndNot, BitwiseAnd, BitwiseAndNot, BitwiseNot,
                    BitwiseOr, BitwiseXor, Not, Or, ShiftLeft, ShiftRight,
                    Xor)
from .elementary import IfNull, IsNull

__all__ = [
    "Alias", "And", "AndNot", "BitwiseAnd", "BitwiseAndNot", "BitwiseNot",
    "BitwiseOr", "BitwiseXor", "BoundExpression", "Const", "ConstBool",
    "ConstDouble", "ConstFloat", "ConstInt32", "ConstInt64", "CppDivide",
    "CppDivideNulling", "CppDivideSignaling", "Divide", "DivideNulling",
    "DivideQuiet", "DivideSignaling", "Equal", "EvalContext",
    "EvaluationError", "Expression", "ExprValue", "Greater",
    "GreaterOrEqual", "IfNull", "IsNull", "Less", "LessOrEqual", "Minus",
    "Modulus", "ModulusNulling", "ModulusSignaling", "Multiply",
    "NamedAttribute", "Negate", "Not", "NotEqual", "Null", "Or", "Plus",
    "Sequence", "ShiftLeft", "ShiftRight", "TypedConst", "Xor", "col",
]
