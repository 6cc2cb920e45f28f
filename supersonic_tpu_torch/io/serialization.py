"""Expression deserialization from a dict/JSON description and from the
reference's protobuf wire format.

Port of ``supersonic_tpu/io/serialization.py`` (reference:
serialization/build_expression_from_proto.cc:754 over
utils/proto/expressions.proto).  The dict form:

    {"constant": {"type": "INT64", "value": 5}}
    {"variable": "col_name"}
    {"operation": {"id": "ADD", "args": [<desc>, <desc>]}}

covers the reference catalog (arithmetic, comparison, logic, control,
casts, math, string, date, stateful); the proto form takes serialized
``ExpressionDescription`` messages.  protobuf is imported only by the
proto entry points (``_pb``), never by ``import supersonic_tpu_torch``.
``expressions_pb2.py`` is the JAX package's module byte for byte: both
register the same ``expressions.proto`` in protobuf's default pool, and a
second copy whose serialized descriptor differed would fail to import
beside it.
"""
from __future__ import annotations

from typing import Any

from .. import exprs as E
from ..exprs.base import Expression
from ..types import DataType


class SerializationError(Exception):
    pass


def _const(desc: dict) -> Expression:
    t = DataType(desc["type"])
    if "value" not in desc or desc["value"] is None:
        return E.Null(t)
    return E.Const(desc["value"], t)


# OperatorId -> factory. Names follow expression/proto/operators.proto.
_OPERATORS: dict[str, Any] = {
    # arithmetic
    "ADD": E.Plus, "SUBTRACT": E.Minus, "MULTIPLY": E.Multiply,
    "DIVIDE_SIGNALING": E.DivideSignaling, "DIVIDE_NULLING": E.DivideNulling,
    "DIVIDE_QUIET": E.DivideQuiet,
    "CPP_DIVIDE_SIGNALING": E.CppDivideSignaling,
    "CPP_DIVIDE_NULLING": E.CppDivideNulling,
    "MODULUS_SIGNALING": E.ModulusSignaling,
    "MODULUS_NULLING": E.ModulusNulling,
    "NEGATE": E.Negate,
    # comparison
    "EQUAL": E.Equal, "NOT_EQUAL": E.NotEqual, "LESS": E.Less,
    "LESS_OR_EQUAL": E.LessOrEqual, "GREATER": E.Greater,
    "GREATER_OR_EQUAL": E.GreaterOrEqual, "IN": E.In,
    "IS_ODD": E.IsOdd, "IS_EVEN": E.IsEven,
    # logic
    "AND": E.And, "OR": E.Or, "AND_NOT": E.AndNot, "XOR": E.Xor,
    "NOT": E.Not,
    "BITWISE_AND": E.BitwiseAnd, "BITWISE_OR": E.BitwiseOr,
    "BITWISE_XOR": E.BitwiseXor, "BITWISE_NOT": E.BitwiseNot,
    "SHIFT_LEFT": E.ShiftLeft, "SHIFT_RIGHT": E.ShiftRight,
    # control
    "IF": E.If, "NULLING_IF": E.NullingIf, "CASE": E.Case,
    "IF_NULL": E.IfNull, "IS_NULL": E.IsNull,
    # math
    "EXP": E.Exp, "LN": E.Ln, "LOG10": E.Log10, "LOG2": E.Log2,
    "LOG": E.Log, "POWER": E.Pow, "SQRT_SIGNALING": E.SqrtSignaling,
    "SQRT_NULLING": E.SqrtNulling, "SQRT_QUIET": E.Sqrt,
    "ROUND": E.Round, "ROUND_TO_INT": E.RoundToInt, "CEIL": E.Ceil,
    "FLOOR": E.Floor, "TRUNC": E.Trunc, "ABS": E.Abs,
    "IS_NAN": E.IsNaN, "IS_INF": E.IsInf, "IS_FINITE": E.IsFinite,
    "IS_NORMAL": E.IsNormal,
    "SIN": E.Sin, "COS": E.Cos, "TAN": E.Tan, "ASIN": E.Asin,
    "ACOS": E.Acos, "ATAN": E.Atan, "SINH": E.Sinh, "COSH": E.Cosh,
    "TANH": E.Tanh, "ASINH": E.Asinh, "ACOSH": E.Acosh, "ATANH": E.Atanh,
    # string
    "LENGTH": E.Length, "LTRIM": E.Ltrim, "RTRIM": E.Rtrim, "TRIM": E.Trim,
    "TO_UPPER": E.ToUpper, "TO_LOWER": E.ToLower, "SUBSTRING": E.Substring,
    "CONCATENATE": E.Concat, "STRING_OFFSET": E.StringOffset,
    "STRING_REPLACE": E.StringReplace,
    # date
    "UNIXTIMESTAMP": E.UnixTimestamp, "FROMUNIXTIME": E.FromUnixTime,
    "MAKEDATE": E.MakeDate, "MAKEDATETIME": E.MakeDatetime,
    "YEAR": E.Year, "QUARTER": E.Quarter, "MONTH": E.Month, "DAY": E.Day,
    "WEEKDAY": E.Weekday, "YEARDAY": E.YearDay, "HOUR": E.Hour,
    "MINUTE": E.Minute, "SECOND": E.Second, "MICROSECOND": E.Microsecond,
    "YEAR_LOCAL": E.YearLocal, "QUARTER_LOCAL": E.QuarterLocal,
    "MONTH_LOCAL": E.MonthLocal, "DAY_LOCAL": E.DayLocal,
    "WEEKDAY_LOCAL": E.WeekdayLocal, "YEARDAY_LOCAL": E.YearDayLocal,
    "HOUR_LOCAL": E.HourLocal, "MINUTE_LOCAL": E.MinuteLocal,
    "SECOND_LOCAL": E.SecondLocal,
    "ADD_DAY": E.AddDays, "ADD_MONTH": E.AddMonths,
    "ADD_MINUTE": E.AddMinutes,
    # stateful
    "CHANGED": E.Changed, "RUNNING_SUM": E.RunningSum, "SMUDGE": E.Smudge,
    "SMUDGE_IF": E.SmudgeIf, "RUNNING_MIN_WITH_FLUSH": E.RunningMinWithFlush,
}


def build_expression(desc: dict) -> Expression:
    """Dict description -> Expression (the BuildExpressionFromProto
    equivalent)."""
    if not isinstance(desc, dict) or len(desc) != 1:
        raise SerializationError(f"bad expression description: {desc!r}")
    kind, body = next(iter(desc.items()))
    if kind == "constant":
        return _const(body)
    if kind == "variable":
        return E.col(body)
    if kind == "operation":
        op_id = body["id"].upper()
        if op_id == "CAST":
            [child] = body["args"]
            return E.CastTo(DataType(body["to_type"]),
                            build_expression(child))
        if op_id not in _OPERATORS:
            raise SerializationError(f"unknown operator {op_id!r}")
        args = [build_expression(a) for a in body.get("args", [])]
        return _OPERATORS[op_id](*args)
    raise SerializationError(f"unknown description kind {kind!r}")


def build_expression_from_json(text: str) -> Expression:
    import json

    return build_expression(json.loads(text))


# ---------------------------------------------------------------------------
# Protobuf wire format (reference: utils/proto/expressions.proto;
# deserializer build_expression_from_proto.cc:754).  The generated module
# expressions_pb2 is wire-compatible with the reference's
# common.ExpressionDescription, so predicates serialized for the reference
# engine deserialize here unchanged.
# ---------------------------------------------------------------------------

# user-registered CUSTOM_FUNCTION_CALL factories: name -> callable(*exprs).
# (The reference leaves BuildFunctionCallFromProto unimplemented,
# build_expression_from_proto.cc:731-735; a registry is strictly more.)
_FUNCTIONS: dict[str, Any] = {}


def register_function(name: str, factory) -> None:
    """Register a CUSTOM_FUNCTION_CALL factory ``factory(*child_exprs)``."""
    _FUNCTIONS[name] = factory


_CONST_VALUE_FIELDS = {
    "INT32": "int32_value", "INT64": "int64_value",
    "UINT32": "uint32_value", "UINT64": "uint64_value",
    "FLOAT": "float_value", "DOUBLE": "double_value",
    "BOOL": "bool_value", "DATE": "date_value",
    "DATETIME": "datetime_value", "BINARY": "binary_value",
    "STRING": "string_value",
}

# OperationType names that differ from (or are missing in) the dict-form
# _OPERATORS table above.  Values are factories over already-built children.
_PROTO_EXTRA_OPS: dict[str, Any] = {
    "DIVIDE": E.Divide, "CPP_DIVIDE": E.CppDivide, "MODULUS": E.Modulus,
    "IFNULL": E.IfNull, "SQRT": E.Sqrt, "SQRT_QUIET": E.Sqrt,
    "POWER_SIGNALING": E.PowSignaling, "POWER_NULLING": E.PowNulling,
    "POWER_QUIET": E.PowQuiet,
    "PI": lambda: E.ConstDouble(3.141592653589793),
    "TOSTRING": E.ToString,  # device for STRING/BOOL/ENUM and bounded
    # domains; raises with the host pointer for unbounded numerics
    "TOUPPER": E.ToUpper, "TOLOWER": E.ToLower, "REPLACE": E.StringReplace,
    "COPY": E.Copy, "FORMAT": E.Format,
    "YEAR_UTC": E.Year, "QUARTER_UTC": E.Quarter, "MONTH_UTC": E.Month,
    "DAY_UTC": E.Day, "WEEKDAY_UTC": E.Weekday, "YEARDAY_UTC": E.YearDay,
    "HOUR_UTC": E.Hour, "MINUTE_UTC": E.Minute,
    "RANDOM_INT32": E.RandInt32, "SEQUENCE": E.Sequence,
}

# unimplemented in the reference deserializer as well
# (build_expression_from_proto.cc: OperatorNotImplemented cases)
_PROTO_UNIMPLEMENTED = frozenset({
    "DATEDIFF", "DATETIMEDIFF", "ADD_WEEK", "ADD_YEAR",
    "TRUNC_TO_SECOND", "TRUNC_TO_MINUTE", "TRUNC_TO_HOUR", "TRUNC_TO_DAY",
    "TRUNC_TO_MONTH", "TRUNC_TO_QUARTER", "TRUNC_TO_YEAR",
    "UNIMPLEMENTED_OPERATOR_0", "UNIMPLEMENTED_OPERATOR_1",
    "UNIMPLEMENTED_OPERATOR_2", "UNIMPLEMENTED_OPERATOR_3",
    "UNIMPLEMENTED_OPERATOR_4", "UNIMPLEMENTED_OPERATOR_5",
})
# implemented by the reference but host-side here (PARITY.md divergences)
_PROTO_HOST_SIDE = {
    "DATE_FORMAT_LOCAL": "ops.host.DateFormat",
    "DATE_FORMAT_UTC": "ops.host.DateFormat",
}


def _pb():
    from . import expressions_pb2

    return expressions_pb2


def _const_from_proto(c) -> Expression:
    pb = _pb()
    tname = pb.DataType.Name(c.type)
    if tname == "NULL_TYPE":
        raise SerializationError("untyped NULL constant needs a type")
    if tname == "DATA_TYPE":
        raise SerializationError(
            "bare DATA_TYPE constant outside CAST/PARSE_STRING")
    field = _CONST_VALUE_FIELDS[tname]
    t = DataType(tname)
    if not c.HasField(field):
        return E.Null(t)
    v = getattr(c, field)
    if tname == "BINARY":
        v = bytes(v)
    return E.Const(v, t)


def _type_const_arg(arg, op_name: str) -> DataType:
    """CAST/PARSE_STRING carry the target type as a leading
    Constant{type: DATA_TYPE, data_type_value} argument."""
    pb = _pb()
    if (pb.ExpressionType.Name(arg.type) != "CONSTANT"
            or pb.DataType.Name(arg.constant.type) != "DATA_TYPE"
            or not arg.constant.HasField("data_type_value")):
        raise SerializationError(
            f"{op_name} needs a DATA_TYPE constant first argument")
    return DataType(pb.DataType.Name(arg.constant.data_type_value))


def _pattern_const_arg(arg, op_name: str) -> str:
    pb = _pb()
    if (pb.ExpressionType.Name(arg.type) != "CONSTANT"
            or pb.DataType.Name(arg.constant.type) != "STRING"):
        raise SerializationError(
            f"{op_name} needs a constant STRING pattern argument")
    return arg.constant.string_value


def _operation_from_proto(op) -> Expression:
    pb = _pb()
    name = pb.OperationType.Name(op.type)
    args = list(op.argument)
    if name in _PROTO_UNIMPLEMENTED:
        raise SerializationError(f"operator {name} is not implemented "
                                 "(unimplemented in the reference too)")
    if name in _PROTO_HOST_SIDE:
        raise SerializationError(
            f"operator {name} runs at host materialization here: use "
            f"{_PROTO_HOST_SIDE[name]} (PARITY.md divergences)")
    if name in ("CAST", "PARSE_STRING"):
        if len(args) != 2:
            raise SerializationError(f"{name} takes exactly 2 arguments")
        t = _type_const_arg(args[0], name)
        child = build_expression_from_proto(args[1])
        if name == "CAST":
            return E.CastTo(t, child)
        # reference uses the nulling parser (bad strings -> NULL),
        # build_expression_from_proto.cc:515
        return E.ParseStringNulling(t, child)
    if name in ("REGEXP_PARTIAL", "REGEXP_FULL", "REGEXP_EXTRACT"):
        if len(args) != 2:
            raise SerializationError(f"{name} takes exactly 2 arguments")
        child = build_expression_from_proto(args[0])
        pattern = _pattern_const_arg(args[1], name)
        fac = {"REGEXP_PARTIAL": E.RegexpPartialMatch,
               "REGEXP_FULL": E.RegexpFullMatch,
               "REGEXP_EXTRACT": E.RegexpExtract}[name]
        return fac(child, pattern)
    if name == "REGEXP_REPLACE":
        if len(args) != 3:
            raise SerializationError("REGEXP_REPLACE takes 3 arguments")
        child = build_expression_from_proto(args[0])
        pattern = _pattern_const_arg(args[1], name)
        sub = build_expression_from_proto(args[2])
        return E.RegexpReplace(child, pattern, sub)
    built = [build_expression_from_proto(a) for a in args]
    fac = _PROTO_EXTRA_OPS.get(name) or _OPERATORS.get(name)
    if fac is None:
        raise SerializationError(f"unknown operator {name!r}")
    return fac(*built)


def build_expression_from_proto(desc) -> Expression:
    """ExpressionDescription proto message -> Expression
    (reference: BuildExpressionFromProto,
    build_expression_from_proto.cc:754).  TUPLE descriptions return a
    list of (possibly aliased) Expressions suitable for ``Compute``."""
    pb = _pb()
    kind = pb.ExpressionType.Name(desc.type)
    if kind == "CONSTANT":
        return _const_from_proto(desc.constant)
    if kind == "VARIABLE":
        return E.col(desc.variable.name)
    if kind == "OPERATION":
        return _operation_from_proto(desc.operation)
    if kind == "CUSTOM_FUNCTION_CALL":
        fname = desc.function_call.function_name
        if fname not in _FUNCTIONS:
            raise SerializationError(
                f"custom function {fname!r} is not registered "
                "(register_function)")
        built = [build_expression_from_proto(a)
                 for a in desc.function_call.argument]
        return _FUNCTIONS[fname](*built)
    if kind == "TUPLE":
        out = []
        for te in desc.tuple.expression:
            e = build_expression_from_proto(te.expression)
            aliases = list(te.alias)
            if len(aliases) == 1:
                e = E.Alias(aliases[0], e)
            elif len(aliases) > 1:
                raise SerializationError(
                    "multi-alias tuple entries need multi-column "
                    "expressions, which are single-column here")
            out.append(e)
        return out
    if kind == "PATH":
        nodes = list(desc.path.node)
        if len(nodes) != 1:
            raise SerializationError(
                "nested column paths are not supported (flat schemas)")
        return E.col(nodes[0])
    raise SerializationError(f"unknown expression type {kind!r}")


def build_expression_from_proto_bytes(data: bytes) -> Expression:
    """Serialized ExpressionDescription bytes (the reference wire format)
    -> Expression."""
    msg = _pb().ExpressionDescription()
    msg.ParseFromString(data)
    return build_expression_from_proto(msg)


def build_sort_order(desc: list):
    """[{"column": "a", "ascending": true, "case_sensitive": true}, ...]
    -> SortOrder (reference: ExtendedSortSpecification,
    proto/specification.proto + specification_builder.cc)."""
    from ..ops.sort import SortKey, SortOrder

    keys = []
    for d in desc:
        keys.append(SortKey(d["column"], d.get("ascending", True),
                            d.get("case_sensitive", True)))
    return SortOrder(keys)


def build_aggregation(desc: list):
    """[{"aggregation": "SUM", "input": "v", "output": "sv",
        "distinct": false, "output_type": "DOUBLE"}, ...]
    -> AggregationSpecification (reference: AggregationSpecification
    proto usage in benchmark/examples)."""
    from ..ops.aggregate import (AggregationSpecification, AggSpec,
                                 Aggregation)

    spec = AggregationSpecification()
    for d in desc:
        spec.add(AggSpec(
            Aggregation[d["aggregation"].upper()], d.get("input"),
            d["output"],
            DataType(d["output_type"]) if d.get("output_type") else None,
            bool(d.get("distinct", False))))
    return spec
