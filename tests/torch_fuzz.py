"""Seeded random plans of the PyTorch-port parity checks (not collected).

One generator serves ``tests/test_torch_jax_suite.py`` (the JAX package
against the port, both on the CPU) and ``chip_smoke.py``'s phase (am) (the
port on the card against the port on the CPU).  It imports numpy only, so
that the card's machine, which has no JAX, imports it too.  A case's
tables are numpy arrays until ``build_table`` puts them into one package;
``make(ns, *tables)`` builds the same plan in either.
"""
import numpy as np


def schema(ns, cols):
    """``cols``: (name, type name, nullable)."""
    return ns.TupleSchema([ns.Attribute(n, getattr(ns.DataType, t), null)
                           for n, t, null in cols])


I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1
FUZZ_WORDS = ("amber", "bravo", "cedar", "delta", "ember", "fjord", "gamma",
              "hazel", "indigo", "jasper", "kilo", "lumen")


def cu_constants(path):
    """The file-scope ``constexpr int NAME = EXPR;`` constants of a CUDA
    source, each evaluated over the ones before it."""
    import re

    names: dict = {}
    with open(path) as f:
        for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                     f.read(), re.M):
            names[name] = int(eval(expr, {"__builtins__": {}}, dict(names)))
    return names


def tile_row_counts(root):
    """Row counts at the kernels' tiles, read from ``csrc``: 0 and 1 rows,
    each tile (spread's output tile, compaction's block) and one row
    either side, and one row past two compaction tiles."""
    import pathlib

    csrc = pathlib.Path(root) / "supersonic_tpu_torch" / "csrc"
    compact = cu_constants(csrc / "compaction.cu")["kTile"]
    spread = cu_constants(csrc / "spread.cu")["kTile"]
    sizes = {0, 1, 2 * compact + 1}
    for tile in (spread, compact):
        sizes |= {tile - 1, tile, tile + 1}
    return sorted(sizes)


class TableSpec:
    """Host columns of one table: ``cols`` (name, type name, nullable),
    ``arrays[name]`` values or (values, valid), ``dicts[name]`` the sorted
    values of a STRING column, ``capacity`` (None: the row count)."""

    def __init__(self, cols, arrays, dicts, n, capacity=None):
        self.cols, self.arrays, self.dicts = tuple(cols), arrays, dicts
        self.n, self.capacity = n, capacity


def build_table(ns, spec, device=None):
    """``spec`` as a table of package ``ns``: the JAX package's when
    ``device`` is None, else the port's on ``device``."""
    if device is None:
        values = {k: a[0] if isinstance(a, tuple) else a
                  for k, a in spec.arrays.items()}
        valids = {k: a[1] for k, a in spec.arrays.items()
                  if isinstance(a, tuple)}
        return ns.Table.from_arrays(
            schema(ns, spec.cols), values, valids, spec.n,
            {k: ns.Dictionary(v) for k, v in spec.dicts.items()},
            spec.capacity)
    return ns.Table.from_numpy(
        schema(ns, spec.cols), spec.arrays, spec.capacity,
        {k: ns.Dictionary(v) for k, v in spec.dicts.items()}, device=device)


def _specials(rng, x, share=0.08):
    """NaNs of both signs and +-0 over a share of ``x``'s rows."""
    pick = rng.random(len(x))
    for lo, v in ((0, np.nan), (share / 4, -np.nan), (share / 2, 0.0),
                  (3 * share / 4, -0.0)):
        x[(pick >= lo) & (pick < lo + share / 4)] = v
    return x


def random_table(rng, n, nullable, key="INT32", key_dom=8, key_lo=0,
                 prefix="", words=FUZZ_WORDS):
    """A table of ``n`` rows: key k (``key`` type, values in [key_lo,
    key_lo + key_dom)), i INT32, l INT64, f FLOAT, d DOUBLE (both with NaNs
    of either sign and +-0), s STRING over ``words``, b BOOL; ``nullable``
    names the nullable columns (a fifth of their rows NULL).  Names take
    ``prefix``."""
    data = {
        "k": (rng.integers(0, key_dom, n) + key_lo).astype(
            np.int32 if key == "INT32" else np.int64),
        "i": rng.integers(-1000, 1000, n).astype(np.int32),
        "l": rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64),
        "f": rng.standard_normal(n).astype(np.float32),
        "d": rng.standard_normal(n) * 100.0,
        "s": rng.integers(0, len(words), n).astype(np.int32),
        "b": rng.random(n) < 0.5,
    }
    _specials(rng, data["f"])
    _specials(rng, data["d"])
    types = {"k": key, "i": "INT32", "l": "INT64", "f": "FLOAT",
             "d": "DOUBLE", "s": "STRING", "b": "BOOL"}
    cols, arrays = [], {}
    for c, v in data.items():
        null = c in nullable
        cols.append((prefix + c, types[c], null))
        arrays[prefix + c] = (v, rng.random(n) >= 0.2) if null else v
    return TableSpec(cols, arrays, {prefix + "s": tuple(words)}, n)


def _nullable(rng):
    return {c for c in "kilfdsb" if rng.random() < 0.5}


def _pick(rng, pool, lo, hi):
    """lo..hi distinct items of ``pool``, in a random order."""
    k = int(rng.integers(lo, hi + 1))
    return [pool[i] for i in rng.permutation(len(pool))[:k]]


def _predicate(ns, rng):
    """A three-valued predicate over a table of ``random_table``."""
    col, C, D = ns.col, ns.Const, ns.DataType
    t = int(rng.integers(-500, 500))
    word = FUZZ_WORDS[int(rng.integers(len(FUZZ_WORDS)))]
    return [
        lambda: (col("i") > C(t)) | col("b"),
        lambda: ~(col("d") < C(0.0, D.DOUBLE)) & ~ns.IsNull(col("l")),
        lambda: col("s").eq(C(word)) | (col("k") < C(3)),
        lambda: ns.In(col("k"), C(1), C(3), C(5)) & (col("f") >= C(
            0.0, D.FLOAT)),
        lambda: ns.IfNull(col("b"), col("i") < C(t)),
    ][int(rng.integers(5))]()


def _sort_keys(ns, rng, names=("k", "i", "l", "s", "b")):
    return [ns.SortKey(c, ascending=bool(rng.random() < 0.5))
            for c in _pick(rng, names, 1, 2)]


class FuzzCase:
    """One seeded plan: ``make(ns, *tables)`` over ``specs``' tables;
    ``float_sums[out] = (spec index, input column)`` for each float SUM."""

    def __init__(self, family, specs, make, float_sums=None, note=""):
        self.family, self.specs, self.make = family, specs, make
        self.float_sums = float_sums or {}
        self.note = note


def _fuzz_filter(rng, sizes):
    spec = random_table(rng, int(rng.choice(sizes)), _nullable(rng))
    seed = int(rng.integers(2 ** 31))
    return FuzzCase("filter", [spec], lambda ns, t: ns.Filter(
        _predicate(ns, np.random.default_rng(seed)), ns.ScanTable(t)))


def _fuzz_sort(rng, sizes):
    n = int(rng.choice(sizes))
    spec = random_table(rng, n, _nullable(rng), key_dom=int(
        rng.integers(1, 40)))
    seed, limit = int(rng.integers(2 ** 31)), int(rng.integers(1, n + 3))
    extended = rng.random() < 0.5

    def make(ns, t):
        keys = _sort_keys(ns, np.random.default_rng(seed))
        if extended:
            return ns.ExtendedSort(keys, ns.ScanTable(t), limit=limit)
        return ns.Sort(keys, ns.ScanTable(t))
    return FuzzCase("sort", [spec], make,
                    note=f"limit {limit}" if extended else "")


AGG_POOL = (("SUM", "i"), ("SUM", "l"), ("SUM", "f"), ("SUM", "d"),
            ("COUNT", "i"), ("COUNT", "s"), ("COUNT", None), ("MIN", "i"),
            ("MAX", "l"), ("MIN", "f"), ("MAX", "d"), ("MIN", "s"),
            ("FIRST", "i"), ("LAST", "d"), ("FIRST", "s"), ("LAST", "b"))


def _aggs(rng, pool=AGG_POOL):
    """2-6 (aggregation, input, output) of ``pool``, and the float SUMs
    among them as ``FuzzCase.float_sums``."""
    aggs = [(agg, src, f"{agg.lower()}_{src or 'star'}_{j}")
            for j, (agg, src) in enumerate(_pick(rng, pool, 2, 6))]
    return aggs, {out: (0, src) for agg, src, out in aggs
                  if agg == "SUM" and src in ("f", "d")}


def _agg_specs(ns, aggs):
    return [ns.AggSpec(getattr(ns.Aggregation, agg), src, out)
            for agg, src, out in aggs]


def _fuzz_group(rng, sizes, f32_sum_nans=True):
    """Dense (small key domain, planner statistics) or sort-path (INT64
    keys spread past any dense budget) group-by, over the table or under
    a Filter."""
    dense = rng.random() < 0.5
    spec = random_table(rng, int(rng.choice(sizes)), _nullable(rng),
                        key="INT32" if dense else "INT64",
                        key_dom=int(rng.integers(1, 30)) if dense else
                        int(rng.integers(5, 3000)),
                        key_lo=int(rng.integers(-5, 5)) if dense else
                        10 ** 12)
    if not dense:  # spread the keys past every dense budget
        k = spec.arrays["k"]
        v = k[0] if isinstance(k, tuple) else k
        v *= 7919
    seed = int(rng.integers(2 ** 31))
    keys = [["k"], ["k", "b"], ["s"], ["k", "s"]][int(rng.integers(4))]
    filtered = rng.random() < 0.3
    aggs, sums = _aggs(np.random.default_rng(seed))
    _f32_sum_nans(spec, sums, f32_sum_nans)

    def make(ns, t):
        child = ns.ScanTable(t)
        if filtered:
            child = ns.Filter(_predicate(ns, np.random.default_rng(seed)),
                              child)
        return ns.GroupAggregate(keys, _agg_specs(ns, aggs), child)
    return FuzzCase("group_dense" if dense else "group_sort", [spec], make,
                    sums, note=f"keys {keys}, filtered {filtered}")


def _f32_sum_nans(spec, sums, keep):
    """Unless ``keep``, the FLOAT column a SUM reads holds no NaN (1.0 in
    its place): the JAX package's f32 tile scan carries a NaN into later
    groups, the port keeps it in its own (tests/test_torch_aggregate.py::
    test_non_finite_sums_stay_in_their_groups)."""
    if keep or ("f" not in {src for _, src in sums.values()}):
        return
    a = spec.arrays["f"]
    v = a[0] if isinstance(a, tuple) else a
    v[np.isnan(v)] = 1.0


def _fuzz_scalar(rng, sizes, f32_sum_nans=True):
    spec = random_table(rng, int(rng.choice(sizes)), _nullable(rng))
    seed = int(rng.integers(2 ** 31))
    pool = tuple(a for a in AGG_POOL if a[0] in ("SUM", "COUNT", "MIN",
                                                 "MAX"))
    aggs, sums = _aggs(np.random.default_rng(seed), pool)
    _f32_sum_nans(spec, sums, f32_sum_nans)
    return FuzzCase("scalar", [spec], lambda ns, t: ns.ScalarAggregate(
        _agg_specs(ns, aggs), ns.ScanTable(t)), sums)


EDGE_INT64 = (I64_MIN, I64_MIN + 1, -7, -1, 0, 1, 2, 7, I64_MAX)
EDGE_INT32 = (I32_MIN, I32_MIN + 1, -7, -1, 0, 1, 7, I32_MAX)
EDGE_DIVISORS = (-1, 0, 1, 2, -7)
EDGE_SHIFTS = (-65, -64, -1, 0, 1, 31, 32, 63, 64, 65, 100)
EDGE_FLOATS = (np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5, 1.5,
               -2.5, 2.0 ** 31, -2.0 ** 31 - 1, 2.0 ** 63, -2.0 ** 63,
               1e19, -1e19, 1e300, -1e300, 123456.789)


def edge_table(rng, n, nullable):
    """Columns of edge values: l INT64 and i INT32 at their ends, m and j
    divisors with 0 and -1, sh shift counts past the width and below 0, x
    DOUBLE and y FLOAT with NaNs, infinities and values past every integer
    range."""
    def draw(pool, dtype):
        return np.array(pool, dtype=dtype)[rng.integers(0, len(pool), n)]

    data = {"l": draw(EDGE_INT64, np.int64), "m": draw(EDGE_DIVISORS,
                                                        np.int64),
            "sh": draw(EDGE_SHIFTS, np.int64), "i": draw(EDGE_INT32,
                                                         np.int32),
            "j": draw(EDGE_DIVISORS, np.int32),
            "x": draw(EDGE_FLOATS, np.float64),
            "y": draw(EDGE_FLOATS, np.float64)}
    with np.errstate(over="ignore"):  # past float32: +-inf
        data["y"] = data["y"].astype(np.float32)
    types = {"l": "INT64", "m": "INT64", "sh": "INT64", "i": "INT32",
             "j": "INT32", "x": "DOUBLE", "y": "FLOAT"}
    cols, arrays = [], {}
    for c, v in data.items():
        null = c in nullable
        cols.append((c, types[c], null))
        arrays[c] = (v, rng.random(n) >= 0.2) if null else v
    return TableSpec(cols, arrays, {}, n)


def edge_exprs(ns, signaling):
    """Integer division and modulus at INT_MIN / -1 and by 0, shifts past
    the width and below 0, negation of INT64_MIN, wrapping products, and
    float-to-integer casts and roundings of NaN, infinities and values
    past the range; ``signaling`` adds a division that raises on a zero
    divisor."""
    col, D = ns.col, ns.DataType
    out = [ns.CppDivideNulling(col("l"), col("m")).as_("q64"),
           ns.ModulusNulling(col("l"), col("m")).as_("r64"),
           ns.CppDivideNulling(col("i"), col("j")).as_("q32"),
           ns.ModulusNulling(col("i"), col("j")).as_("r32"),
           ns.ShiftLeft(col("l"), col("sh")).as_("shl"),
           ns.ShiftRight(col("l"), col("sh")).as_("shr"),
           ns.Negate(col("l")).as_("neg"),
           (col("l") * ns.ConstInt64(3)).as_("mul"),
           (col("i") + col("i")).as_("add32"),
           ns.CastTo(D.INT64, col("x")).as_("x64"),
           ns.CastTo(D.INT32, col("x")).as_("x32"),
           ns.CastTo(D.INT32, col("y")).as_("y32"),
           ns.CastTo(D.FLOAT, col("x")).as_("xf"),
           ns.RoundToInt(col("x")).as_("rnd"),
           ns.FloorToInt(col("x")).as_("flo"),
           ns.TruncToInt(col("y")).as_("trc")]
    if signaling:
        out.append(ns.CppDivideSignaling(col("l"), col("m")).as_("qs"))
    return out


def _fuzz_compute(rng, sizes):
    spec = edge_table(rng, int(rng.choice(sizes)),
                      {c for c in ("l", "m", "sh", "i", "j", "x", "y")
                       if rng.random() < 0.4})
    signaling = rng.random() < 0.25
    return FuzzCase("compute", [spec], lambda ns, t: ns.Compute(
        edge_exprs(ns, signaling), ns.ScanTable(t)),
        note=f"signaling {signaling}")


JOIN_TYPES = ("INNER", "LEFT_OUTER", "RIGHT_OUTER", "FULL_OUTER")


def _fuzz_join(rng, sizes):
    """HashJoin of every JoinType x UNIQUE/NOT_UNIQUE x
    allow_dense_lookup, INT32, INT64 or STRING keys, NULL keys, empty
    sides, the probe side under a Filter at times."""
    jt = JOIN_TYPES[int(rng.integers(4))]
    unique = rng.random() < 0.5
    dense = rng.random() < 0.5
    key = ["INT32", "INT64", "STRING"][int(rng.integers(3 if not unique
                                                        else 2))]
    nl = int(rng.choice(sizes))
    nr = int(rng.choice([0, 1, 5, 100] + list(sizes)))
    # NOT_UNIQUE: a small key domain, wide enough that the expansion
    # stays near 20k rows (STRING keys: fewer build rows over the words)
    if key == "STRING":
        nr = min(nr, 20000 * len(FUZZ_WORDS) // max(nl, 1))
    dom = max(2 * nr, 16) if unique else max(int(rng.integers(1, 40)),
                                             nl * nr // 20000 + 1)
    lo = int(rng.integers(-3, 3)) if rng.random() < 0.7 else 10 ** 10
    if key == "INT32" and lo > I32_MAX // 2:
        lo = 0
    ktype = "INT64" if key == "INT64" else "INT32"
    lhs = random_table(rng, nl, _nullable(rng), key=ktype,
                       key_dom=int(dom * 1.25) + 1, key_lo=lo)
    rhs = random_table(rng, nr, _nullable(rng) - ({"k"} if unique else set()),
                       key=ktype, key_dom=dom, key_lo=lo, prefix="r")
    if unique:  # distinct build keys
        rhs.arrays["rk"] = (rng.permutation(dom)[:nr] + lo).astype(
            rhs.arrays["rk"].dtype)
    lk, rk = ("s", "rs") if key == "STRING" else ("k", "rk")
    out_cap = _join_rows(lhs, rhs, lk, rk, jt) + 1
    filtered = rng.random() < 0.3
    seed = int(rng.integers(2 ** 31))

    def make(ns, lt, rt):
        left = ns.ScanTable(lt)
        if filtered:
            left = ns.Filter(_predicate(ns, np.random.default_rng(seed)),
                             left)
        return ns.HashJoin(
            getattr(ns.JoinType, jt), [lk], [rk], left, ns.ScanTable(rt),
            getattr(ns.KeyUniqueness, "UNIQUE" if unique else
                    "NOT_UNIQUE"), out_capacity=out_cap,
            allow_dense_lookup=dense)
    return FuzzCase("join", [lhs, rhs], make, note=(
        f"{jt} {'UNIQUE' if unique else 'NOT_UNIQUE'} dense {dense} key "
        f"{key} {nl} x {nr} filtered {filtered}"))


def _join_rows(lhs, rhs, lk, rk, jt):
    """The most rows the join can emit (every probe row kept)."""
    def live(spec, c):
        a = spec.arrays[c]
        return a[0][a[1]] if isinstance(a, tuple) else a
    keys, counts = np.unique(live(rhs, rk), return_counts=True)
    per_key = dict(zip(keys.tolist(), counts.tolist()))
    rows = sum(per_key.get(k, 0) for k in live(lhs, lk).tolist())
    if jt in ("LEFT_OUTER", "FULL_OUTER"):
        rows += lhs.n
    if jt in ("RIGHT_OUTER", "FULL_OUTER"):
        rows += rhs.n
    return rows


def _fuzz_union(rng, sizes):
    """MergeUnionAll of two sorted children (the second STRING dictionary
    a different subset of words), or UnionAll with a filtered child."""
    nullable = _nullable(rng)
    a = random_table(rng, int(rng.choice(sizes)), nullable,
                     key_dom=int(rng.integers(1, 50)))
    words = tuple(sorted(_pick(rng, FUZZ_WORDS, 1, len(FUZZ_WORDS))))
    b = random_table(rng, int(rng.choice(sizes)), nullable,
                     key_dom=int(rng.integers(1, 50)), words=words)
    merge = rng.random() < 0.6
    seed = int(rng.integers(2 ** 31))

    def make(ns, at, bt):
        r = np.random.default_rng(seed)
        if merge:
            keys = _sort_keys(ns, r)
            return ns.MergeUnionAll(keys, [ns.Sort(keys, ns.ScanTable(at)),
                                           ns.Sort(keys, ns.ScanTable(bt))])
        return ns.UnionAll(ns.ScanTable(at), ns.Filter(
            _predicate(ns, r), ns.ScanTable(bt)))
    return FuzzCase("merge_union" if merge else "union_all", [a, b], make)


FUZZ_FAMILIES = (_fuzz_filter, _fuzz_sort, _fuzz_group, _fuzz_scalar,
                 _fuzz_compute, _fuzz_join, _fuzz_union)


def random_case(seed, sizes, f32_sum_nans=True):
    """The seeded plan ``seed``: the families in turn, so that any seven
    seeds in a row cover each of them, at row counts drawn from
    ``sizes``; ``f32_sum_nans`` as in ``_f32_sum_nans``."""
    rng = np.random.default_rng(seed)
    family = FUZZ_FAMILIES[seed % len(FUZZ_FAMILIES)]
    if family in (_fuzz_group, _fuzz_scalar):
        return family(rng, sizes, f32_sum_nans)
    return family(rng, sizes)


def run_case(ns, case, device=None):
    """Execute ``case`` in package ``ns`` (``device`` as in
    ``build_table``): ("rows", schema, rows) or ("raises", exception type
    name, message)."""
    tables_ = [build_table(ns, s, device) for s in case.specs]
    try:
        out = ns.execute(case.make(ns, *tables_))
    except Exception as e:  # the other route must raise it too
        return ("raises", type(e).__name__, str(e))
    return ("rows", [(a.name, a.type.value, a.nullable) for a in out.schema],
            out.to_pylist())


def _sum_bound(case, out):
    """How far two float SUMs of column ``out`` may part: the accumulation
    order differs (PARITY.md:217-221), so DOUBLE sums within 1e-12 of the
    input's sum of magnitudes, FLOAT sums within the float32 worst case
    of a sum in any order, 2 (n - 1) 2^-24 of it."""
    idx, src = case.float_sums[out]
    spec = case.specs[idx]
    a = spec.arrays[src]
    vals = a[0][a[1]] if isinstance(a, tuple) else a
    mag = float(np.abs(vals[np.isfinite(vals)].astype(np.float64)).sum())
    if vals.dtype == np.float32:
        return 2 * max(spec.n - 1, 1) * 2.0 ** -24 * mag
    return 1e-12 * mag


def compare_results(case, want, got):
    """(rows compared, None) when ``got`` equals ``want`` (``run_case``'s
    results): the same schema and rows in order, every value bit for bit
    (NaN by isnan, NULLs equal) but the float SUMs within ``_sum_bound``;
    or the same exception type and message.  Else (rows compared, a text
    of the first mismatch)."""
    if want[0] != got[0] or want[1] != got[1]:
        return 0, f"want {want[:2]} {want[2] if want[0] == 'raises' else ''}"\
            f", got {got[:2]} {got[2] if got[0] == 'raises' else ''}"
    if want[0] == "raises":
        return 0, None if want[2] == got[2] else \
            f"message: want {want[2]!r}, got {got[2]!r}"
    names = [c[0] for c in want[1]]
    wrows, grows = want[2], got[2]
    if len(wrows) != len(grows):
        return 0, f"rows: want {len(wrows)}, got {len(grows)}"
    for r, (wr, gr) in enumerate(zip(wrows, grows)):
        for name, a, b in zip(names, wr, gr):
            if _same_value(a, b):
                continue
            if (name in case.float_sums and a is not None and b is not None
                    and np.isfinite(a) and np.isfinite(b)
                    and abs(a - b) <= _sum_bound(case, name)):
                continue
            return r, (f"row {r} column {name}: want {a!r}, got {b!r}; "
                       f"want row {wr}, got row {gr}")
    return len(wrows), None


def _same_value(a, b):
    if isinstance(a, float) and isinstance(b, float):
        if a != a or b != b:
            return a != a and b != b
        return repr(a) == repr(b)
    return type(a) is type(b) and a == b


def sweep_data(rng, n, null_p=0.15, key_dom=25):
    """tests/test_differential_sweep.py:24-33's nullable columns k, v, x
    and s, as Python lists (None = NULL)."""
    def maybe_null(vals):
        return [None if rng.random() < null_p else v for v in vals]

    return {
        "k": maybe_null(rng.integers(0, key_dom, n).tolist()),
        "v": maybe_null(rng.integers(-50, 50, n).tolist()),
        "x": maybe_null(np.round(rng.random(n) * 10, 3).tolist()),
        "s": maybe_null([f"w{int(i)}" for i in rng.integers(0, 12, n)]),
    }


def sweep_rows(data, n):
    """The rows of ``sweep_data``, for ``reference.ref_engine``."""
    return [tuple(data[c][i] for c in ("k", "v", "x", "s"))
            for i in range(n)]
