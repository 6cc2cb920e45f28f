"""Expression factories of the port: the JAX package's whole surface
(``supersonic_tpu/exprs/__init__.py``), with the same names."""
from .base import (Alias, AttributeAt, BoundExpression, EvalContext,
                   EvaluationError, ExprValue, Expression,
                   InputAttributeProjection, NamedAttribute, Projection, col)
from .terminal import (Const, ConstBinary, ConstBool, ConstDataType, ConstDate,
                       ConstDateTime, ConstDouble, ConstFloat, ConstInt32,
                       ConstInt64, ConstString, ConstUint32, ConstUint64, Null,
                       RandInt32, Sequence, TypedConst)
from .arithmetic import (CppDivide, CppDivideNulling, CppDivideSignaling,
                         Divide, DivideNulling, DivideQuiet, DivideSignaling,
                         Minus, Modulus, ModulusNulling, ModulusSignaling,
                         Multiply, Negate, Plus)
from .comparison import (Equal, Greater, GreaterOrEqual, In, IsEven, IsOdd,
                         Less, LessOrEqual, NotEqual)
from .logic import (And, AndNot, BitwiseAnd, BitwiseAndNot, BitwiseNot,
                    BitwiseOr, BitwiseXor, Not, Or, ShiftLeft, ShiftRight, Xor)
from .elementary import (Case, CastNulling, CastQuiet, CastSignaling, CastTo,
                         Copy, If, IfNull, IsNull, NullingIf,
                         ParseStringNulling, ParseStringQuiet)
from .math import (Abs, Acos, Acosh, Asin, Asinh, Atan, Atan2, Atanh, Ceil,
                   CeilToInt, Cos, Cosh, Cot, Exp, Floor, FloorToInt, Format,
                   FormatSignaling, IsFinite, IsInf, IsNaN, IsNormal, Ln,
                   LnNulling, LnQuiet, LnSignaling, Log, Log10, Log10Nulling,
                   Log10Quiet, Log10Signaling, Log2, Log2Nulling, Log2Quiet,
                   Log2Signaling, LogNulling, LogQuiet, Pi, Pow, PowNulling,
                   PowQuiet, PowSignaling, PowerNulling, PowerQuiet,
                   PowerSignaling, RandomDouble, Round, RoundToInt,
                   RoundWithMultiplier, RoundWithPrecision, Sin, Sinh, Sqrt,
                   SqrtNulling, SqrtQuiet, SqrtSignaling, Tan, Tanh, ToDegrees,
                   ToRadians, Trunc, TruncToInt)
from .string import (Concat, ConcatWithSeparator, Concatenate, Length, Ltrim,
                     Rtrim, StringContains, StringContainsCI, StringOffset,
                     StringReplace, Substring, SubstringSignaling, ToLower,
                     ToString, ToUpper, TrailingSubstring, Trim)
from .date import (AddDay, AddDays, AddMinute, AddMinutes, AddMonth, AddMonths,
                   ConstDateTimeFromMicrosecondsSinceEpoch,
                   ConstDateTimeFromSecondsSinceEpoch, DateFormat,
                   DateFormatLocal, DateToDatetime, Day, DayLocal,
                   FromUnixTime, Hour, HourLocal, MakeDate, MakeDatetime,
                   Microsecond, MicrosecondLocal, Minute, MinuteLocal, Month,
                   MonthLocal, Now, ParseDateTime, Quarter, QuarterLocal,
                   Second, SecondLocal, UnixTimestamp, Weekday, WeekdayLocal,
                   Year, YearDay, YearDayLocal, YearLocal)
from .tz import (get_local_timezone, set_local_timezone)
from .stateful import (Changed, RunningMinWithFlush, RunningSum, Smudge,
                       SmudgeIf)
from .regexp import (RegexpExtract, RegexpFullMatch, RegexpPartialMatch,
                     RegexpReplace)
from .hashing import (Fingerprint, Hash, SupersonicFingerprint, SupersonicHash)

__all__ = [
    "Abs", "Acos", "Acosh", "AddDay", "AddDays", "AddMinute", "AddMinutes",
    "AddMonth", "AddMonths", "Alias", "And", "AndNot", "Asin", "Asinh", "Atan",
    "Atan2", "Atanh", "AttributeAt", "BitwiseAnd", "BitwiseAndNot",
    "BitwiseNot", "BitwiseOr", "BitwiseXor", "BoundExpression", "Case",
    "CastNulling", "CastQuiet", "CastSignaling", "CastTo", "Ceil", "CeilToInt",
    "Changed", "Concat", "ConcatWithSeparator", "Concatenate", "Const",
    "ConstBinary", "ConstBool", "ConstDataType", "ConstDate", "ConstDateTime",
    "ConstDateTimeFromMicrosecondsSinceEpoch",
    "ConstDateTimeFromSecondsSinceEpoch", "ConstDouble", "ConstFloat",
    "ConstInt32", "ConstInt64", "ConstString", "ConstUint32", "ConstUint64",
    "Copy", "Cos", "Cosh", "Cot", "CppDivide", "CppDivideNulling",
    "CppDivideSignaling", "DateFormat", "DateFormatLocal", "DateToDatetime",
    "Day", "DayLocal", "Divide", "DivideNulling", "DivideQuiet",
    "DivideSignaling", "Equal", "EvalContext", "EvaluationError", "Exp",
    "ExprValue", "Expression", "Fingerprint", "Floor", "FloorToInt", "Format",
    "FormatSignaling", "FromUnixTime", "Greater", "GreaterOrEqual", "Hash",
    "Hour", "HourLocal", "If", "IfNull", "In", "InputAttributeProjection",
    "IsEven", "IsFinite", "IsInf", "IsNaN", "IsNormal", "IsNull", "IsOdd",
    "Length", "Less", "LessOrEqual", "Ln", "LnNulling", "LnQuiet",
    "LnSignaling", "Log", "Log10", "Log10Nulling", "Log10Quiet",
    "Log10Signaling", "Log2", "Log2Nulling", "Log2Quiet", "Log2Signaling",
    "LogNulling", "LogQuiet", "Ltrim", "MakeDate", "MakeDatetime",
    "Microsecond", "MicrosecondLocal", "Minus", "Minute", "MinuteLocal",
    "Modulus", "ModulusNulling", "ModulusSignaling", "Month", "MonthLocal",
    "Multiply", "NamedAttribute", "Negate", "Not", "NotEqual", "Now", "Null",
    "NullingIf", "Or", "ParseDateTime", "ParseStringNulling",
    "ParseStringQuiet", "Pi", "Plus", "Pow", "PowNulling", "PowQuiet",
    "PowSignaling", "PowerNulling", "PowerQuiet", "PowerSignaling",
    "Projection", "Quarter", "QuarterLocal", "RandInt32", "RandomDouble",
    "RegexpExtract", "RegexpFullMatch", "RegexpPartialMatch", "RegexpReplace",
    "Round", "RoundToInt", "RoundWithMultiplier", "RoundWithPrecision",
    "Rtrim", "RunningMinWithFlush", "RunningSum", "Second", "SecondLocal",
    "Sequence", "ShiftLeft", "ShiftRight", "Sin", "Sinh", "Smudge", "SmudgeIf",
    "Sqrt", "SqrtNulling", "SqrtQuiet", "SqrtSignaling", "StringContains",
    "StringContainsCI", "StringOffset", "StringReplace", "Substring",
    "SubstringSignaling", "SupersonicFingerprint", "SupersonicHash", "Tan",
    "Tanh", "ToDegrees", "ToLower", "ToRadians", "ToString", "ToUpper",
    "TrailingSubstring", "Trim", "Trunc", "TruncToInt", "TypedConst",
    "UnixTimestamp", "Weekday", "WeekdayLocal", "Xor", "Year", "YearDay",
    "YearDayLocal", "YearLocal", "col", "get_local_timezone",
    "set_local_timezone",
]
