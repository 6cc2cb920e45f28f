"""Host-evaluated operations for results with no dense device encoding.

Port of ``supersonic_tpu/ops/host.py`` (numpy only).  The reference's
CONCAT aggregation builds a variable-length string per group
(aggregation_operators.h:235-283, values joined by ","); strings have no
dense device form mid-query, so the device computes the grouping and the
host joins the bytes, through the port's C++ assembly (``native/``) or,
without a host compiler, a Python loop.  ``to_string``, ``format_number``
and ``concat_columns`` render a column at host materialization, and
``_assemble_render`` renders the rows of a ``DeferredRender`` (ToString,
Format, DateFormat and DateFormatLocal without a domain) after the run.
"""
from __future__ import annotations

import datetime
import time
from typing import Optional, Sequence

import numpy as np

from .. import tracing
from ..batch import Table
from ..schema import Attribute, TupleSchema
from ..types import DataType, from_carrier
from .base import Operation, execute
from .scan import ScanTable

# the route the last CONCAT assembly took: "native" (C++) or "python"
concat_route: Optional[str] = None


def _host(x) -> np.ndarray:
    """A tensor (or a number) as a host numpy array."""
    if hasattr(x, "cpu"):
        return tracing.to_host(x, "host").numpy()
    return np.asarray(x)


def resolve_deferred(entries, cancel=None) -> None:
    """Resolve the deferred dictionaries of a run, after its flags' host
    sync (ops/base.py::execute): each DeferredConcat or DeferredRender reads
    its aux tensors back and assembles its strings.  ``cancel`` is polled
    before each."""
    for m in entries:
        if cancel is not None:
            cancel.check()
        if hasattr(m, "kind"):
            _assemble_render(m, m.aux)
        else:
            _assemble_concat(m, m.aux)


def _strftime(fmt: str, secs: int) -> str:
    """strftime of gmtime into the reference's 33-byte buffer: a rendering
    past 32 characters is "" (date_evaluators.cc:227-265); "NULL" where
    the time is out of range."""
    try:
        s = time.strftime(fmt, time.gmtime(secs))
    except (OverflowError, OSError, ValueError):
        s = "NULL"
    return s if len(s) <= 32 else ""


def _secs(vals: np.ndarray, input_type: DataType) -> np.ndarray:
    """DATE days or DATETIME microseconds as whole seconds, microseconds
    cut toward zero as C++ integer division does."""
    v = vals.astype(np.int64)
    if input_type == DataType.DATE:
        return v * 86400
    return np.where(v >= 0, v // 1000000, -((-v) // 1000000))


def _render_keys(m, live: np.ndarray):
    """(keys, render): the rows of a DeferredRender render alike where
    their keys are equal, and ``render(unique keys)`` gives the strings of
    those keys: a float's bits, an integer's value, a DATETIME's second,
    a date format's bucket of its finest directive's granule (the
    domain path's buckets, exprs/date.py)."""
    t = m.input_type
    if m.kind == "dateformat":
        from ..exprs.date import _format_granule_sec

        g = 86400 if t == DataType.DATE else _format_granule_sec(m.fmt)
        secs = _secs(live, t)
        return secs - secs % g, lambda u: [_strftime(m.fmt, int(x))
                                           for x in u]
    if live.dtype.kind == "f":  # by bits: -0.0 prints apart from 0.0
        bits = live.view(np.int32 if live.itemsize == 4 else np.int64)
        dt = live.dtype
        if m.kind == "format":
            return bits, lambda u: _fmt_fixed(u.view(dt), m.precision)
        return bits, lambda u: _ref_prints(u.view(dt), t)
    if m.kind == "format":
        return live, lambda u: _fmt_fixed(u, m.precision)
    if t == DataType.DATETIME:
        secs = _secs(live, t)
        return secs, lambda u: _ref_prints(u * 1000000, t)
    if t == DataType.DATE:
        return live, lambda u: _ref_prints(u, t)
    return live, lambda u: u.astype(str).tolist()


def _assemble_render(m, aux) -> None:
    """The strings of a DeferredRender: row i's string is dictionary entry
    i (the device column holds row-position codes), "" where ``ok`` is
    False (dead or NULL rows).  Each distinct key renders once (the JAX
    package's ``_assemble_render`` renders every row; the strings are the
    same)."""
    vals = from_carrier(_host(aux["vals"]), m.input_type)
    ok = np.flatnonzero(_host(aux["ok"]).astype(bool))
    strings = np.full(vals.shape[0], "", dtype=object)
    if ok.size:
        keys, render = _render_keys(m, vals[ok])
        uniq, inv = np.unique(keys, return_inverse=True)
        rendered = np.array(list(render(uniq)) + [""], dtype=object)
        strings[ok] = rendered[inv.reshape(-1)]
    m.dict_obj.resolve(strings.tolist())


def _fmt_fixed(v: np.ndarray, precision) -> list:
    """FORMAT's "%.*f" of each value (precision clamped at 0)."""
    return np.char.mod(f"%.{max(int(precision), 0)}f",
                       v.astype(np.float64)).tolist()


def _fmt_floats(f: np.ndarray) -> list:
    """FloatToBuffer (utils/strings/numbers.cc:1273-1297) of a float32
    array: "%.6g", again at "%.8g" where the printed form does not parse
    back to the same float32.  C's varargs widen the float to a double
    before snprintf, so formatting the widened value gives the same
    bytes."""
    f = np.asarray(f, dtype=np.float32)
    with np.errstate(invalid="ignore"):  # a signaling NaN widens quietly
        return _round_trip(f.astype(np.float64), f, "%.6g", "%.8g")


def _fmt_doubles(d: np.ndarray) -> list:
    """DoubleToBuffer (utils/strings/numbers.cc:1249-1271) of a float64
    array: "%.15g", again at "%.17g" where strtod does not give the same
    double back."""
    d = np.asarray(d, dtype=np.float64)
    return _round_trip(d, d, "%.15g", "%.17g")


def _round_trip(wide: np.ndarray, v: np.ndarray, short: str,
                full: str) -> list:
    """``short`` of each value of ``wide``, again at ``full`` where the
    printed form does not parse back to the same value of ``v``'s type."""
    xs = wide.tolist()
    out = [short % x for x in xs]
    with np.errstate(invalid="ignore", over="ignore"):
        back = np.array([float(s) for s in out]).astype(v.dtype)
        redo = np.flatnonzero(~(back == v)).tolist()
    for i in redo:
        out[i] = full % xs[i]
    return out


def _ref_prints(vals: np.ndarray, type_: DataType) -> list:
    """``_ref_print`` of each value of an array, floats in one numpy
    pass."""
    if type_ == DataType.FLOAT:
        return _fmt_floats(vals)
    if type_ == DataType.DOUBLE:
        return _fmt_doubles(vals)
    return [_ref_print(v, type_) for v in vals]


def _ref_print(v, type_: DataType) -> str:
    """The reference's PrintTyped (types_infrastructure.cc:45-130):
    integers in decimal, BOOL TRUE/FALSE, DATE %Y/%m/%d, DATETIME
    %Y/%m/%d-%H:%M:%S (microseconds cut toward zero, as C++ integer
    division does; "NULL" where the time is out of range), floats by
    SimpleFtoa/SimpleDtoa, ENUM as its number."""
    if type_ == DataType.BOOL:
        return "TRUE" if v else "FALSE"
    if type_ == DataType.DATE:
        try:
            d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
        except OverflowError:
            return "NULL"
        return d.strftime("%Y/%m/%d")
    if type_ == DataType.DATETIME:
        usec = int(v)
        secs = usec // 1000000 if usec >= 0 else -((-usec) // 1000000)
        try:
            dt = (datetime.datetime(1970, 1, 1)
                  + datetime.timedelta(seconds=secs))
        except OverflowError:
            return "NULL"
        return dt.strftime("%Y/%m/%d-%H:%M:%S")
    if type_ in (DataType.FLOAT, DataType.DOUBLE):
        return _ref_prints([v], type_)[0]
    return str(int(v))


def _payloads(vals: np.ndarray, input_type: DataType, input_dict):
    """(payload bytes list, int32 payload index per row): a STRING/BINARY
    column's dictionary entries, else each distinct value as the reference
    prints it."""
    if input_dict is not None:
        payloads = ([v if isinstance(v, bytes) else str(v).encode()
                     for v in input_dict.values] or [b""])
        return payloads, np.clip(vals.astype(np.int32), 0, len(payloads) - 1)
    uniq, inv = np.unique(from_carrier(vals, input_type), return_inverse=True)
    payloads = [p.encode() for p in _ref_prints(uniq, input_type)] or [b""]
    return payloads, inv.astype(np.int32).reshape(-1)


def _join_groups(payloads, codes, valid, starts, separator: bytes,
                 distinct: bool) -> list:
    """Each group's valid payloads joined in row order (None for a group
    without one): the C++ assembly, or the Python loop without it."""
    global concat_route
    from .. import native

    g = len(starts) - 1
    lengths = np.fromiter((len(p) for p in payloads), dtype=np.int64,
                          count=len(payloads))
    offsets = np.zeros(len(payloads) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    res = native.concat_groups(b"".join(payloads), offsets, codes, valid,
                               starts, separator, distinct)
    if res is not None:
        concat_route = "native"
        blob, lens = res
        out_off = np.zeros(g + 1, dtype=np.int64)
        np.cumsum(np.maximum(lens, 0), out=out_off[1:])
        return [None if lens[i] < 0 else
                blob[out_off[i]:out_off[i + 1]].decode(
                    errors="surrogateescape") for i in range(g)]
    concat_route = "python"
    out = []
    for gi in range(g):
        parts, seen = [], set()
        for r in range(int(starts[gi]), int(starts[gi + 1])):
            if valid is not None and not valid[r]:
                continue
            c = int(codes[r])
            if distinct:
                if c in seen:
                    continue
                seen.add(c)
            parts.append(payloads[c])
        out.append(separator.join(parts).decode(errors="surrogateescape")
                   if parts else None)
    return out


def _assemble_concat(m, aux) -> None:
    """The strings of one CONCAT aggregate (reference: the
    AggregationOperator<CONCAT> loop, aggregation_operators.h:235-283:
    "," separator, NULL inputs skipped, values as PrintTyped prints them).
    The rows of ``aux`` come grouped (``gid`` non-decreasing), a group's
    rows in input order; ``valid`` leaves out dead and NULL rows.  An
    all-NULL group resolves to "" under a NULL output row."""
    gid = _host(aux["gid"])
    vals = _host(aux["vals"])
    valid = _host(aux["valid"]).astype(bool)
    ng = max(int(_host(aux["num_groups"])), 0)
    if ng == 0:
        m.dict_obj.resolve(())
        return
    payloads, codes = _payloads(vals, m.input_type, m.input_dict)
    # group starts over the grouped rows: dead rows carry the last live
    # gid but are not valid, so they add nothing
    starts = np.concatenate([np.searchsorted(gid, np.arange(ng)),
                             [len(gid)]]).astype(np.int64)
    strings = _join_groups(payloads, codes, valid, starts,
                           m.separator.encode(), m.distinct)
    m.dict_obj.resolve(["" if s is None else s for s in strings])


def group_concat(table_or_plan, group_by: Sequence[str], input_col: str,
                 output: str, separator: str = ",",
                 distinct: bool = False) -> Table:
    """GROUP BY keys -> CONCAT(input) AS output (reference: Aggregation
    CONCAT, proto/supersonic.proto:69).  The grouping is a stable device
    sort by the keys (a group's rows stay in input order, the reference's
    append order); the bytes are joined on the host.  Returns a Table on
    the input's device: the keys and a STRING column, groups in
    first-appearance order."""
    src = (execute(table_or_plan) if isinstance(table_or_plan, Operation)
           else table_or_plan)
    from .sort import Sort

    names = list(group_by)
    n = int(tracing.to_host(src.num_rows, "host.num_rows"))
    key_attrs = [src.schema.lookup(k) for k in names]
    out_schema = TupleSchema(
        key_attrs + [Attribute(output, DataType.STRING, True)])
    if n == 0:
        return Table.from_data(out_schema, {a.name: [] for a in out_schema},
                               device=src.device)
    srt = execute(Sort(names, ScanTable(src)))  # stable: input order kept
    kvals = {k: _host(srt.columns[k].values)[:n] for k in names}
    kvalid = {k: (None if srt.columns[k].valid is None
                  else _host(srt.columns[k].valid)[:n]) for k in names}
    boundary = np.zeros(n, dtype=bool)
    boundary[0] = True
    for k in names:
        v = kvals[k]
        boundary[1:] |= v[1:] != v[:-1]
        if kvalid[k] is not None:
            boundary[1:] |= kvalid[k][1:] != kvalid[k][:-1]
    group_starts = np.flatnonzero(boundary)
    starts = np.concatenate([group_starts, [n]]).astype(np.int64)
    c = srt.columns[input_col]
    vals = _host(c.values)[:n]
    valid = None if c.valid is None else _host(c.valid)[:n]
    payloads, codes = _payloads(vals, src.schema.lookup(input_col).type,
                                srt.dicts.get(input_col))
    concat_vals = _join_groups(payloads, codes, valid, starts,
                               separator.encode(), distinct)
    # groups in first-appearance order: the first row of each group in
    # the input, from the same stable order over the input's rows
    perm = _stable_sort_permutation(src, names, n)
    app_order = np.argsort(perm[group_starts], kind="stable")
    data: dict = {}
    for k in names:
        kv = kvals[k][group_starts][app_order]
        if k in srt.dicts:
            dv = srt.dicts[k].values
            col_vals = [dv[int(x)] if 0 <= int(x) < len(dv) else None
                        for x in kv]
        else:
            col_vals = [x.item() for x in kv]
        if kvalid[k] is not None:
            ok = kvalid[k][group_starts][app_order]
            col_vals = [v if o else None for v, o in zip(col_vals, ok)]
        data[k] = col_vals
    data[output] = [concat_vals[i] for i in app_order]
    return Table.from_data(out_schema, data, device=src.device)


def _stable_sort_permutation(src: Table, names: Sequence[str],
                             n: int) -> np.ndarray:
    """The input row of each position of a stable sort by the keys."""
    from .keys import group_code_columns

    ops = []
    for nr, code in group_code_columns(src, list(names)):
        if nr is not None:
            ops.append(_host(nr)[:n])
        ops.append(_host(code)[:n])
    if not ops:
        return np.arange(n)
    # np.lexsort: the LAST key is the primary; stable
    return np.lexsort(tuple(reversed(ops)))


def _with_column(src: Table, output: str, out_vals: list) -> Table:
    """``src``'s live rows with a STRING column ``output`` appended."""
    cols = src.to_numpy()
    data = {a.name: list(cols[a.name]) for a in src.schema}
    data[output] = out_vals
    out_schema = src.schema.concat(TupleSchema(
        [Attribute(output, DataType.STRING, True)]))
    return Table.from_data(out_schema, data, device=src.device)


def to_string(table_or_plan, input_col: str, output: str,
              fmt: Optional[str] = None) -> Table:
    """A column as STRING at host materialization (reference: ToString,
    string_bound_expressions.cc; DateFormat for DATE/DATETIME with
    ``fmt``): the child runs on the device, the rendering is host work,
    and the result is dictionary-encoded again.  Appends ``output``."""
    src = (execute(table_or_plan) if isinstance(table_or_plan, Operation)
           else table_or_plan)
    attr = src.schema.lookup(input_col)
    out_vals = []
    for v in src.to_numpy()[input_col]:
        if v is None:
            out_vals.append(None)
        elif attr.type == DataType.DATE:
            d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
            out_vals.append(d.strftime(fmt or "%Y/%m/%d"))
        elif attr.type == DataType.DATETIME:
            dt = (datetime.datetime(1970, 1, 1)
                  + datetime.timedelta(microseconds=int(v)))
            out_vals.append(dt.strftime(fmt or "%Y/%m/%d-%H:%M:%S"))
        elif isinstance(v, bool):
            out_vals.append("TRUE" if v else "FALSE")
        elif attr.type in (DataType.FLOAT, DataType.DOUBLE):
            out_vals.append(_ref_print(v, attr.type))
        else:
            out_vals.append(str(v))
    return _with_column(src, output, out_vals)


DateFormat = to_string  # the reference's name for DATE/DATETIME


def format_number(table_or_plan, input_col: str, precision: int,
                  output: str) -> Table:
    """FORMAT(col, precision) at host materialization (reference:
    math_evaluators.h:39-59, "%.*f" with the precision clamped at 0)."""
    src = (execute(table_or_plan) if isinstance(table_or_plan, Operation)
           else table_or_plan)
    prec = max(int(precision), 0)
    out_vals = [None if v is None else ("%.*f" % (prec, float(v)))
                for v in src.to_numpy()[input_col]]
    return _with_column(src, output, out_vals)


def concat_columns(table_or_plan, input_cols: Sequence[str], output: str,
                   separator: str = "") -> Table:
    """Row-wise CONCAT of columns at host materialization (reference:
    BoundConcatExpression, string_bound_expressions.cc; NULL where any
    input is NULL); other types are rendered with ``str``, BOOL as
    true/false."""
    src = (execute(table_or_plan) if isinstance(table_or_plan, Operation)
           else table_or_plan)
    cols = src.to_numpy()
    out_vals: list = []
    for i in range(int(tracing.to_host(src.num_rows, "host.num_rows"))):
        parts = []
        for name in input_cols:
            v = cols[name][i]
            if v is None:
                parts = None
                break
            if isinstance(v, bool):
                v = "true" if v else "false"
            parts.append(v if isinstance(v, str) else str(v))
        out_vals.append(None if parts is None else separator.join(parts))
    return _with_column(src, output, out_vals)
