#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (supersonic_tpu_torch).

Drives the port's main paths on one CUDA card at real size: the headline
query (BASELINE.json configs 4/5: FK build 1M x probe 100M, 64 groups)
under both of its bindings, the multi-match join of bench_ops.py:188-206
("join NOT_UNIQUE dup8") scaled to emit 100M rows (dim 1M rows, 8 per
key; fact 12.5M rows), the sorted merge of bench_ops.py:281-299
("merge_union 2x4M") scaled to 2 x 50M rows, bench_ops.py's two
group-bys ("groupby 8M->1M keys", "groupby_str 8M->50") and a DOUBLE
SUM into 64 groups (TPC-H Q1's shape) at 100M rows, and the joins that
take the merge probe, STRING keys and the outer join types:

  1. environment: torch version, the card, nvidia-smi's name and power limit
  2. build: compiles the CUDA kernels from csrc/ (one nvcc per source, all
     at once; timed)
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes: compaction, LUT gather, spread and merge_sorted
     bit for bit (ragged tails, capacities below the total, out-of-range
     indices, payloads of 1, 2, 4 and 8 bytes, no source, repeated starts,
     heavy ties, uneven and empty sides, live counts below capacity;
     compaction of nothing and of everything, at one tile and one tile
     +-1, cut at a tile's edge and inside a tile, over odd-offset views,
     32 mixed payloads, and more than 2^16 tiles five times in a row;
     spread with starts on tile edges, a run of the stage's size and one
     past it, the row add beside other widths, odd-offset views; the
     LUT gather's specialised lane signatures, an index slice at an odd
     offset and its generic route; the merge over raw int32, int64,
     float32, float64 (NaNs of both signs, +-0), bool and STRING-code keys,
     ASC and DESC, with and without NULLs); the segment reduce keyed by
     raw key lanes (the headline group-by's call, five runs with
     bit-identical f32 sums; every mode at K = 300 over an INT64 + INT32
     key with kmin != 0, kept rows outside the domain and NaNs of both
     signs and +-0; K = 2048 with 16 requests; odd-offset views) and in
     its ids form, every output bit for bit but f32 sums (rtol 1e-4), NaN
     slots by isnan.  Each is timed beside its
     plain version, one PyTorch call computing the same function where
     there is one, and its bound: the bytes it must move over the card's
     3.35 TB/s; compaction also at each caller's shape and spread at joins
     (a)'s and (b)'s
  4. the main paths, each from zeroed launch counters: the headline plan of
     bench.py:73-86 through ``execute`` (one segment-reduce launch), then
     Filter on its own and an unmasked UNIQUE join over a permuted primary
     key (the two operators that compact); then four joins: (a) the dup8
     INNER join, 100M rows;
     (b) LEFT_OUTER NOT_UNIQUE under Filter(v > 0.5) with half the keys
     missing; (c) LEFT_OUTER UNIQUE of the 100M-row fact against half its
     dim; (f) the same join through the fat-LUT probe against a dim whose
     keys each sit on two rows (the last one wins), five runs alike; then
     two sorted merges: (d) MergeUnionAll of two 50M-row runs
     sorted by (g ASC, v DESC), 100M rows; (e) a 4-way MergeUnionAll of
     25M-row runs by (k INT64 nullable ASC, d DOUBLE DESC) with NaNs of
     both signs and +-0, carrying a STRING column whose runs have four
     dictionaries, then the UnionAll of the same runs; then three
     group-bys: (g) bench_ops.py:136-140's "groupby 8M->1M keys" at the
     headline's 100M rows (SUM v, COUNT(*), SUM d DOUBLE, MAX v: the sort
     path, twice, bit for bit); (j) TPC-H Q1's shape, a DOUBLE SUM into
     64 groups under a fused Filter by an INT64 key of huge values (the
     sort path over the kept rows' compacted ids, twice, bit for bit); (h)
     bench_ops.py:234-238's "groupby_str
     8M->50" at 100M rows (dense by the dictionary, one segment-reduce
     launch); then four more joins: (k) bench_ops.py:153-160's
     "join 8M x 1M (merge probe)" over the headline tables, 100M rows;
     (l) the dup8 (a) join over INT64 keys spread past every dense budget
     (the merge probe, 100M rows); (m) bench_ops.py:260-278's "join_str
     8M x 1M" at 100M x 1M, whose build side holds a quarter of its
     values in a dictionary of its own; (n) RIGHT_OUTER and FULL_OUTER
     NOT_UNIQUE of dup8 (b)'s tables (about 50M and 56.25M rows).  Each
     is checked against numpy.  Then (e)'s three fold steps, each timed
     with its bound and its launches.  Then the aggregates and secondary
     operators (o)-(t) and a CONCAT group-by (see their functions), and
     the expression engine at 100M rows: (u) bench_ops.py:240-258's
     "compute c0*(sin+exp)" and a Compute of RoundWithPrecision,
     RoundToInt, CastSignaling, LnNulling and Abs; (v) TPC-H Q14's promo
     revenue over (o)'s lineitem rows with a STRING p_type (the spec's 150
     types), ScalarAggregate(SUM(If(RegexpPartialMatch(p_type, "^PROMO"),
     rev, 0)), SUM(rev)) under a month of l_shipdate; (w) TPC-H Q12's
     shape, a group-by of Year(l_shipdate) and l_shipmode counting
     high-priority lines (Case over o_orderpriority) under In(l_shipmode,
     'MAIL', 'SHIP'); (x) Year, Month, Day, Hour, Weekday, AddMonths and a
     DateFormat under a domain over 100M instants of 1992-2000, then
     HourLocal and DayLocal in America/New_York (checked with offsets
     from zoneinfo, not the port's LUT); (y) the stateful golden's plan
     with a flush about every 1000 rows; (z) Fingerprint and Hash, a
     group-by keyed by BitwiseAnd(Hash(fk), 63), a Sort of UINT64 values
     past 2^63, and the host render of ToString and DateFormat over 1M
     rows.  The LUT gather is also checked and timed at this slice's two
     call shapes (a 150-entry LUT, the 3-lane time-zone LUT).  Then the
     files and the spills: (aa) ``save`` and ``load(device="cuda")`` of
     the headline fact (100M rows), (m)'s STRING dim (1M rows) and a 1M-row
     table with one nullable column of each of the 13 types, every value
     and NULL bit-equal, each way's median of 5 and its MB/s; (ab)
     bench_ops.py:136-140's "groupby 8M->1M keys" at its 8M rows as a
     HybridGroupAggregate under a memory quota of 1M pregroup rows (8
     chunks spilled through the external sort, merged by the C++ k-way
     merge), against numpy and the plan without a quota; (ac)
     bench_ops.py:143-145's "sort 8M by (g,v)" as a SortWithTempDirPrefix
     under an eighth of its working set (8 runs), against the in-memory
     Sort; each with its median of 5, its launches and its disk bytes.
     Then the tooling and distribution: (ad) the benchmark harness
     (``bench.benchmark_plan``, CUDA events) over the headline plan, every
     node's rows against numpy and the join's build/probe split, its
     ``format_stats`` table; (ae) the headline twin of bench.py
     (``bench/headline.py``) at its own 8M x 1M, its JSON line; (af)
     ``entry()`` on the card against ``entry(device="cpu")``; (ag)
     distribution at world size 1 over NCCL on this card (a failed NCCL
     initialisation fails the smoke): ``parallel.dryrun(1)``, then the
     headline through ``dist_map`` (Filter), ``dist_hash_join``,
     ``dist_group_aggregate`` and ``dist_sort`` at 100M x 1M against the
     single-card headline in order, its median of 5, its launches and its
     probe exchange's bytes.  Then the twins of the JAX side's programs at
     their own sizes, each plan from zeroed launch counters, its rows
     checked by the twin's numpy check, its best and median of 5 printed:
     (ah) ``bench/ops.py``'s fifteen plans of bench_ops.py at 8M x 1M
     ("join 8M x 1M (merge probe)" through the merge probe, the plain
     join not); (ai) ``bench/configs.py``'s configs 2-4 of
     scripts/bench_configs.py (10M rows into 50 and ~3.9M keys, a Sort of
     100M rows, a join of 100M x 1M), freed one after another; (aj)
     ``bench/stress_edges.py``'s capacity edges at full size (17M rows,
     NOT_UNIQUE joins at 95% and 93% of out_capacity, overflow flags
     read); (ak) ``examples/operation_example.py``'s five workloads at
     100k rows under the harness, DOT files written; (al)
     ``bench/dist.py``'s ``run`` and ``analyze`` at world size 1 over
     NCCL at 1M x 100k: the rows equal the single-card plan's and
     numpy's, the efficiency is null, the exchanges equal EXCHANGE.json's
     P = 1 record.  Then (am), the card's route against the CPU route,
     from zeroed launch counters: seeded random plans of
     tests/torch_fuzz.py (Filter with three-valued predicates, Sort and
     ExtendedSort with a limit, dense and sort-path GroupAggregate with
     SUM, COUNT, COUNT(*), MIN, MAX, FIRST and LAST, ScalarAggregate, a
     Compute over integer and float edge values, HashJoin in every
     JoinType x UNIQUE/NOT_UNIQUE x allow_dense_lookup with empty sides,
     MergeUnionAll and UnionAll) over nullable INT32, INT64, FLOAT, DOUBLE,
     STRING and BOOL columns at 0, 1 and each kernel tile's row count and
     one either side (read from csrc/), 200 seeds or as many as 30 s hold,
     each on the card and on the CPU from the same numpy data: rows equal
     in order, values bit for bit but float SUMs within their order bound,
     the same exception where the CPU raises; the cases of
     tests/test_differential_sweep.py and tests/test_capacity_edges.py
     through ``testing.check_operation`` on the card; and (ab)'s and (ac)'s
     full-size spills under a token that interrupts at its fourth poll
     (tests/test_errors.py's FlipAfter(3)): each raises Interrupted and
     leaves no file, the rerun equals the in-memory plan.  Each of the five
     CUDA kernels must launch in (am).  Then (an), the star's group-by at
     SSB SF 20: 120M rows of capacity, two INT32/STRING keys and an INT64
     SUM under a keep mask of ~1M, no and every row, exact against numpy,
     with the GroupAggregate node's CUDA-event ms
  5. the median times of the headline query (under both bindings, and
     its aggregate in insertion order under both), of join (a), of merges
     (d) and (e), of group-bys (g), (h) and (j), of joins (k)-(n) and of
     the paths (o)-(z)

It prints one JSON line of per-kernel results, then as its last line
``{"ok": true, "device": {...}}``.  It exits non-zero, and prints no
result, when any phase fails or no CUDA device is present.  It takes no
arguments: the sizes are always the ones above.

    python3 chip_smoke.py
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

FACT_ROWS = 100_000_000  # BASELINE.json configs 4/5: probe 100M
DIM_ROWS = 1_000_000     # ... FK build 1M
GROUPS = 64              # bench.py's group count
REPEATS = 5              # timed runs of the query
SUM_RTOL = 1e-4  # f32 sums (why: see check_headline)
DUP_DIM_ROWS = 1_000_000      # bench_ops.py:188-206's dim, 8 rows per key
DUP_KEYS = DUP_DIM_ROWS // 8
DUP_FACT_ROWS = 12_500_000    # probe rows: the join emits 100M
DUP_OUT = 8 * DUP_FACT_ROWS
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
MERGE_RUN_ROWS = 50_000_000   # bench_ops.py:281-299's 2 x 4M runs, scaled
MERGE4_RUN_ROWS = 25_000_000  # path (e): 4 runs
HI_KEYS = DIM_ROWS            # path (g): bench_ops.py:136-140's 1M keys
FEW_GROUPS = 64               # path (j): a DOUBLE SUM into a few groups
FEW_KEY_STEP = 10**12         # path (j): INT64 keys far above the row count
Q1_ROWS = 120_000_000         # the 64-bit sum words at TPC-H Q1's shape
DOUBLE_RTOL = 1e-12           # DOUBLE sums, of the group's sum of |d|
WORDS = sorted([              # path (h): bench_ops.py:219-226's 50 keys
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "india", "juliett", "kilo", "lima", "mike", "november",
    "oscar", "papa", "quebec", "romeo", "sierra", "tango", "uniform",
    "victor", "whiskey", "xray", "yankee", "zulu", "amber", "bronze",
    "copper", "dune", "ember", "flint", "granite", "harbor", "island",
    "jade", "krypton", "lagoon", "meadow", "nickel", "onyx", "prairie",
    "quartz", "ridge", "summit", "tundra", "umber", "valley", "willow",
    "zenith"])


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps=10, calls=5):
    """Time of one fn() in ms, after one warm-up call: the median over
    ``reps`` windows of CUDA-event time over ``calls`` back-to-back calls,
    so the host's launch work overlaps the device's and is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound_ms(nbytes):
    """Least time to move ``nbytes`` through device memory, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def moved_bytes(inputs, outputs):
    """Bytes a call must move: each distinct input storage read once (a lane
    passed both as a key and as a payload is one read), each output written
    once."""
    reads = {t.data_ptr(): t.numel() * t.element_size() for t in inputs}
    return sum(reads.values()) + sum(t.numel() * t.element_size()
                                     for t in outputs)


def timings(torch, kernel, plain, library, nbytes):
    """ms, plain_ms, library_ms (None without a library call), bound_ms and
    bound_by of one kernel: CUDA-event medians, then the byte bound."""
    return {"ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain),
            "library_ms": None if library is None else cuda_ms(torch, library),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes"}


def bits(t):
    """Integer view of a tensor, so float payloads compare bit for bit."""
    import torch

    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def max_abs_diff(a, b):
    """Largest |a - b| over two equal-shape tensors, as a float."""
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def make_data():
    """bench.py:29-39's data, at the smoke's size, from default_rng(42)."""
    rng = np.random.default_rng(42)
    fact = {"fk": rng.integers(0, DIM_ROWS, FACT_ROWS).astype(np.int32),
            "v": rng.random(FACT_ROWS, dtype=np.float32)}
    dim = {"pk": np.arange(DIM_ROWS, dtype=np.int32),
           "g": rng.integers(0, GROUPS, DIM_ROWS).astype(np.int32)}
    return fact, dim


def dup8_data():
    """The dup8 join's data from default_rng(42): fact (fk uniform over the
    125,000 keys, v) and dim (pk = arange // 8, so each key is on 8
    consecutive rows, w in [0, 64)); then run (b)'s fk, uniform over twice
    the keys so half of them miss."""
    rng = np.random.default_rng(42)
    fact = {"fk": rng.integers(0, DUP_KEYS, DUP_FACT_ROWS).astype(np.int32),
            "v": rng.random(DUP_FACT_ROWS, dtype=np.float32)}
    dim = {"pk": (np.arange(DUP_DIM_ROWS) // 8).astype(np.int32),
           "w": rng.integers(0, 64, DUP_DIM_ROWS).astype(np.int32)}
    fk_half = rng.integers(0, 2 * DUP_KEYS, DUP_FACT_ROWS).astype(np.int32)
    return fact, dim, fk_half


def dup8_schemas(T):
    return (T.TupleSchema.of(("fk", T.INT32, False), ("v", T.FLOAT, False)),
            T.TupleSchema.of(("pk", T.INT32, False), ("w", T.INT32, False)))


def dup8_plan(T, fact_t, dim_t, join_type, filtered):
    """bench_ops.py:188-218's join: fk = pk against a NOT_UNIQUE dim,
    projecting v and w, into 100M rows."""
    lhs = T.ScanTable(fact_t)
    if filtered:
        lhs = T.Filter(T.col("v") > T.Const(0.5, T.FLOAT), lhs)
    return T.HashJoin(join_type, ["fk"], ["pk"], lhs, T.ScanTable(dim_t),
                      T.KeyUniqueness.NOT_UNIQUE,
                      lhs_projector=T.Projector.named("v"),
                      rhs_projector=T.Projector.named("w"),
                      out_capacity=DUP_OUT)


def schemas(T):
    """(fact schema, dim schema) of bench.py's tables."""
    return (T.TupleSchema.of(("fk", T.INT32, False), ("v", T.FLOAT, False)),
            T.TupleSchema.of(("pk", T.INT32, False), ("g", T.INT32, False)))


def headline_plan(T, fact_t, dim_t):
    """bench.py:73-86's plan: Filter(v > 0.5) -> UNIQUE INNER join on
    fk = pk -> group by g with SUM(v), COUNT -> Sort(sv DESC)."""
    return T.Sort(
        [T.SortKey("sv", ascending=False)],
        T.GroupAggregate(
            ["g"],
            [T.AggSpec(T.Aggregation.SUM, "v", "sv"),
             T.AggSpec(T.Aggregation.COUNT, None, "c")],
            T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"],
                       T.Filter(T.col("v") > T.Const(0.5, T.FLOAT),
                                T.ScanTable(fact_t)),
                       T.ScanTable(dim_t), T.KeyUniqueness.UNIQUE,
                       lhs_projector=T.Projector.named("v"),
                       rhs_projector=T.Projector.named("g")),
            T.GroupAggregateOptions(estimated_result_row_count=GROUPS)))


def check_compaction(torch, fk, v, keep):
    """The compaction kernel bit for bit against its plain version: the
    Filter's shape, out_cap below the kept count, every payload width, a
    ragged length, nothing and everything kept, one tile and one tile +-1,
    out_cap at a tile's edge and inside a tile, a mask and payloads that
    are views at odd offsets (the element-load instance), 32 payloads of
    mixed widths, and more than 2^16 tiles run 5 times in a row (a race in
    the look-back would show as a run that differs); then timed at the
    Filter's shape and at each caller's shape."""
    from supersonic_tpu_torch.kernels.compaction import (TILE_ROWS,
                                                         compact_arrays_ref,
                                                         compact_kernel,
                                                         vector_loads)

    from supersonic_tpu_torch.kernels import library

    assert library().ss_compact_tile_rows() == TILE_ROWS
    n = keep.shape[0]
    kept = int(keep.sum())
    g = torch.Generator(device="cuda").manual_seed(7)

    def rand(m, dtype):
        if dtype == torch.bool:
            return torch.rand(m, device="cuda", generator=g) < 0.5
        if dtype.is_floating_point:
            return torch.randn(m, device="cuda", generator=g, dtype=dtype)
        lo, hi = ((-2**62, 2**62) if dtype == torch.int64 else
                  (torch.iinfo(dtype).min, torch.iinfo(dtype).max))
        return torch.randint(lo, hi, (m,), device="cuda", generator=g,
                             dtype=dtype)

    # (name, payloads, mask, out_cap, whether 16-byte loads apply)
    cases = [("main", [fk, v], keep, n, True),
             ("out_cap<kept", [fk, v], keep, kept // 2, True)]
    m = 1_000_003  # ragged: not a multiple of the tile
    mask = torch.rand(m, device="cuda", generator=g) < 0.37
    widths = (torch.float64, torch.int64, torch.bool, torch.float32,
              torch.int16)
    wide = [rand(m, t) for t in widths]  # every width moves natively
    cases += [("1/2/4/8-byte payloads, ragged", wide, mask, m, True),
              ("nothing kept", wide, torch.zeros_like(mask), m, True),
              ("everything kept", wide, torch.ones_like(mask), m, True)]
    for rows in (TILE_ROWS - 1, TILE_ROWS, TILE_ROWS + 1):
        cases.append((f"n = {rows}", [x[:rows] for x in wide], mask[:rows],
                      rows, True))
    # the kept rows up to the end of tile 100, and 777 rows into tile 101
    edge = int(mask[:101 * TILE_ROWS].sum())
    cases += [("out_cap at a tile edge", wide, mask, edge, True),
              ("out_cap inside a tile", wide, mask, edge + 777, True)]
    odd = [rand(m + 3, t)[3:] for t in widths]
    odd_mask = (torch.rand(m + 1, device="cuda", generator=g) < 0.5)[1:]
    cases += [("odd-offset mask and payloads", odd, odd_mask, m, False),
              ("odd-offset mask", wide, odd_mask, m, False),
              ("one odd-offset payload", wide[:2] + odd[2:3], mask, m,
               False)]
    mixed = [rand(m, widths[i % len(widths)]) for i in range(32)]
    cases.append(("32 payloads of mixed widths", mixed, mask, m // 2, True))
    err = 0.0
    for name, pays, msk, cap, vec in cases:
        assert vector_loads([msk] + pays) == vec, f"compaction {name}: route"
        got, cnt = compact_kernel(pays, msk, cap)
        want, wcnt = compact_arrays_ref(pays, msk, cap)
        c = int(cnt)
        assert c == int(wcnt), (name, c, int(wcnt))
        for a, b in zip(got, want):
            assert torch.equal(bits(a[:c]), bits(b[:c])), f"compaction {name}"
            err = max(err, max_abs_diff(a[:c], b[:c]))
    names = [c[0] for c in cases]
    del cases, wide, odd, mixed, got, want
    # more than 2^16 tiles, five runs in a row, each bit for bit
    big = (2**16 + 5) * TILE_ROWS + 1234
    bmask = torch.rand(big, device="cuda", generator=g) < 0.5
    bpays = [torch.arange(big, dtype=torch.int32, device="cuda"),
             rand(big, torch.bool)]
    want, wcnt = compact_arrays_ref(bpays, bmask, big)
    for run in range(5):
        got, cnt = compact_kernel(bpays, bmask, big)
        c = int(cnt)
        assert c == int(wcnt), ("more than 2^16 tiles", run, c)
        assert all(torch.equal(a[:c], b[:c]) for a, b in zip(got, want)), \
            f"compaction: more than 2^16 tiles, run {run + 1} differs"
        del got
    names.append(f"{-(-big // TILE_ROWS)} tiles, 5 runs")
    del bmask, bpays, want
    torch.cuda.synchronize()
    t = timings(torch, lambda: compact_kernel([fk, v], keep, n),
                lambda: compact_arrays_ref([fk, v], keep, n),
                lambda: [torch.masked_select(p, keep) for p in (fk, v)],
                n * (1 + 4 + 4) + kept * (4 + 4))
    log(f"kernel compaction: bit-exact on {len(names)} cases "
        f"({'; '.join(names)}; main n={n}, kept={kept}); {t}")
    # each call shape of the driven paths: rows, 4-byte lanes, kept share
    g = torch.Generator(device="cuda").manual_seed(8)
    shapes = [("Filter", n, 2, None), ("unmasked UNIQUE join", n, 3, None),
              ("(a) lhs rows that emit", DUP_FACT_ROWS, 3, 1.0),
              ("(b) lhs rows that emit", DUP_FACT_ROWS, 4, 0.5),
              ("(k) run starts, live build rows", n, 1, 0.01)]
    per_call = []
    distinct = [fk, v, fk ^ 1, v * 2]
    for name, rows, lanes, share in shapes:
        msk = keep[:rows] if share is None else (
            torch.rand(rows, device="cuda", generator=g) < share)
        pays = [x[:rows] for x in distinct[:lanes]]
        k = int(msk.sum())
        ms = cuda_ms(torch, lambda: compact_kernel(pays, msk, rows))
        bound = bound_ms(rows * (1 + 4 * lanes) + k * 4 * lanes)
        per_call.append({"call": name, "rows": rows, "lanes": lanes,
                         "kept": k, "ms": ms, "bound_ms": bound,
                         "over_bound_ms": ms - bound})
    del distinct
    log(f"compaction per call shape: {json.dumps(per_call)}")
    return {"max_abs_err": err, **t}


def check_lut_gather(torch, fk, dim_g):
    """The LUT gather bit for bit against its plain version: each lane
    signature the joins use (specialised kernels), 8-byte and 32-lane sets
    (the generic kernel), a length that is not a multiple of 8, an index
    slice at an odd offset, indices out of range both ways, and the staged
    route; then timed at the row-id probe's shape."""
    from supersonic_tpu_torch.kernels.lut_gather import (lut_gather,
                                                         lut_gather_ref,
                                                         specialised, staged)

    dev = fk.device
    K = dim_g.shape[0]
    idx = fk.clone()
    idx[:1000] = -5          # out of range below
    idx[1000:2000] = K + 7   # out of range above
    flag = torch.arange(K, device=dev) % 3 != 0
    start = torch.arange(K, dtype=torch.int32, device=dev) * 8
    v = torch.linspace(-1, 1, K, device=dev)
    small_k = 2048
    small = [torch.arange(small_k, dtype=torch.int32, device=dev) * 3,
             torch.linspace(-1, 1, small_k, device=dev),
             torch.arange(small_k, device=dev) % 3 == 0,
             torch.arange(small_k, device=dev, dtype=torch.float64) / 7]
    sidx = (fk % (small_k + 64) - 32).to(torch.int32)
    ragged = idx[1:12_345_679]  # odd offset: not 16-byte aligned; n % 8 = 6
    cases = [
        # (name, luts, idx, K, specialised)
        ("row-id probe", [dim_g], idx, K, True),
        ("CSR (count, start)", [dim_g, start], idx, K, True),
        ("fat-LUT probe", [dim_g, flag], idx, K, True),
        ("two values and the flag", [dim_g, v, flag], idx, K, True),
        ("three 4-byte lanes", [v, dim_g, start], ragged, K, True),
        ("odd-offset slice, n % 8 = 6", [dim_g, flag], ragged, K, True),
        ("8-byte lanes", [dim_g.double(), dim_g.long()], ragged, K, False),
        ("32 lanes", [dim_g] * 32, idx[:3_000_001], K, False),
        ("staged", small, sidx, small_k, False),
        ("staged, one lane", small[:1], sidx[3:], small_k, True),
        # the merge probe: the build flags at the sorted row ids (one
        # 1-byte lane), a run's start read back by its (sorted) run id
        ("merge probe: build flags", [flag], idx, K, False),
        ("merge probe: run starts", [start], torch.sort(idx)[0], K, True),
    ]
    err = 0.0
    for name, luts, ix, k, spec in cases:
        assert specialised(luts) == spec, f"lut_gather {name}: route"
        got = lut_gather(luts, ix, k)
        want = lut_gather_ref(luts, ix, k)
        for a, b in zip(got, want):
            assert torch.equal(bits(a), bits(b)), f"lut_gather {name}"
            err = max(err, max_abs_diff(a, b))
    assert not staged([dim_g], K) and staged(small, small_k)
    del cases, got, want, ragged
    torch.cuda.synchronize()
    n = fk.shape[0]  # fk lies in [0, K): index_select needs no clip
    t = timings(torch, lambda: lut_gather([dim_g], fk, K),
                lambda: lut_gather_ref([dim_g], fk, K),
                lambda: torch.index_select(dim_g, 0, fk),
                n * 4 + K * 4 + n * 4)
    log(f"kernel lut_gather: bit-exact on 12 cases (n={n}, K={K}; "
        f"specialised: one, two and three 4-byte lanes, with a 1-byte flag, "
        f"an odd-offset slice, sorted indices; generic: 8-byte lanes, 32 "
        f"lanes, a lone 1-byte lane; staged); {t}")
    return {"max_abs_err": err, **t}


def check_lut_gather_slice(torch, fk):
    """The LUT gather at the expression engine's two call shapes, bit for
    bit against its plain version and timed beside ``index_select`` and
    the byte bound: a 150-entry int32 LUT (path (v)'s p_type property LUT)
    at 100M indices, and the 65536-entry 3-lane time-zone day LUT (path
    (x)'s local shift, America/New_York) at 100M day indices."""
    from supersonic_tpu_torch.exprs import tz
    from supersonic_tpu_torch.kernels.lut_gather import (lut_gather,
                                                         lut_gather_ref)

    dev = fk.device
    n = fk.shape[0]
    lut150 = torch.arange(150, dtype=torch.int32, device=dev) * 7 - 300
    idx150 = (fk % 150).to(torch.int32)
    tzt = tz._compile(LOCAL_ZONE)
    lanes = [torch.from_numpy(a).to(dev) for a in
             (tzt.off_before, tzt.off_after, tzt.switch_sec)]
    days = (fk % 3288 + (8035 - tz.DAY0)).to(torch.int32)  # 1992-2000
    out = []
    for name, luts, idx, k in (("150-entry int32 LUT", [lut150], idx150,
                                150),
                               ("3-lane time-zone LUT", lanes, days,
                                tz.NDAYS)):
        got = lut_gather(luts, idx, k)
        want = lut_gather_ref(luts, idx, k)
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"lut_gather {name}"
        t = timings(
            torch, lambda: lut_gather(luts, idx, k),
            lambda: lut_gather_ref(luts, idx, k),
            lambda: [torch.index_select(x, 0, idx) for x in luts],
            n * 4 + sum(x.numel() * 4 for x in luts) + len(luts) * n * 4)
        log(f"lut_gather per call shape: {name} at {n} indices, bit-exact; "
            f"{t}")
        out.append(t)
    return out


def seg_compare(torch, name, got, want, reqs, rtol=SUM_RTOL,
                f64_rtol=DOUBLE_RTOL):
    """Kernel and plain outputs of segment-reduce requests ((values, mode)
    or (values, valid, mode)): f32 sums within ``rtol`` and f64 sums within
    ``f64_rtol`` (another order of adds; callers give f64 sums values of
    one sign), everything else bit for bit; NaN slots by isnan.  Returns
    the largest |difference| over the slots that hold no NaN."""
    err = 0.0
    for r, a, b in zip(reqs, got, want):
        mode, values = r[-1], r[0]
        assert a.dtype == b.dtype and a.shape == b.shape, (name, mode)
        if a.is_floating_point():
            na, nb = a.isnan(), b.isnan()
            assert torch.equal(na, nb), f"{name} {mode}: NaN slots differ"
            a, b = a[~na], b[~nb]
        if mode == "sum" and values is not None and \
                values.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=rtol, atol=0,
                                       msg=f"{name} f32 sum")
        elif mode == "sum64" and a.dtype == torch.float64:
            fin = b.isfinite()
            assert torch.equal(a[~fin], b[~fin]), f"{name} f64 sum: infs"
            a, b = a[fin], b[fin]
            rel = float(((a - b).abs() / b.abs().clamp(min=1e-300)).max()) \
                if a.numel() else 0.0
            assert rel <= f64_rtol, f"{name} f64 sum: rel diff {rel:.3g}"
        else:
            assert torch.equal(bits(a), bits(b)), f"{name} {mode}"
        err = max(err, max_abs_diff(a, b))
    return err


def signed_zeros_and_nans(torch, x, g, nans=16):
    """x (f32) with its zeros' signs set at random and ``nans`` NaNs of each
    sign at random rows, all by their bits (a float NaN operand may lose its
    sign on the card)."""
    m = x.shape[0]
    xi = x.view(torch.int32)
    sign = (torch.rand(m, device=x.device, generator=g) < 0.5).to(
        torch.int32) << 31  # the bits of -0.0 or +0.0
    xi = torch.where((xi & 0x7FFFFFFF) == 0, sign, xi)
    at = torch.randint(0, m, (2 * nans,), device=x.device, generator=g)
    xi[at[:nans]] = 0x7FC00000          # +NaN
    xi[at[nans:]] = -0x00400000         # -NaN (0xFFC00000)
    return xi.view(torch.float32)


def check_segment_reduce(torch, g_lane, v, keep):
    """The segment-reduce kernel against its plain version: the keyed form
    at the headline group-by's shape (raw g, keep, v: count and f32 sum, 5
    runs bit-identical); every mode at K = 300 over an INT64 + INT32 key
    with kmin != 0, kept rows out of the domain, a device row count, NaNs
    of both signs and +-0; K = 2048 with 16 requests; odd-offset views;
    the ids form at K = 64 and 300.  Then timed: the keyed form at the
    headline's shape (the main path's call) and the ids form at the same
    shape."""
    from supersonic_tpu_torch.kernels import library
    from supersonic_tpu_torch.kernels.segment_reduce import (
        SMEM_BYTES, THREADS, per_thread_accumulators, segment_reduce_keyed,
        segment_reduce_keyed_ref, segment_reduce_multi,
        segment_reduce_multi_ref, vector_loads)

    lib = library()
    assert lib.ss_segment_reduce_threads() == THREADS
    assert lib.ss_segment_reduce_smem_bytes() == SMEM_BYTES
    dev = v.device
    n = v.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(11)
    names, err = [], 0.0

    def keyed(name, keys, reqs, K, keep=None, num_rows=None, vec=True,
              per_thread=None, runs=1):
        nonlocal err
        inputs = [k for k, _, _ in keys] + ([] if keep is None else [keep])
        inputs += [t for r in reqs for t in r[:2] if t is not None]
        assert vector_loads(inputs) == vec, f"segment_reduce {name}: loads"
        if per_thread is not None:
            assert per_thread_accumulators(K, reqs) == per_thread, \
                f"segment_reduce {name}: instance"
        want, wbad = segment_reduce_keyed_ref(keys, reqs, K, keep, num_rows)
        first = None
        for run in range(runs):
            got, bad = segment_reduce_keyed(keys, reqs, K, keep, num_rows)
            assert int(bad) == int(wbad), (name, int(bad), int(wbad))
            err = max(err, seg_compare(torch, f"segment_reduce {name}", got,
                                       want, reqs))
            if first is None:
                first = got
            else:  # every output, f32 sums included, the same bits
                assert all(torch.equal(bits(a), bits(b))
                           for a, b in zip(got, first)), \
                    f"segment_reduce {name}: run {run + 1} differs"
        names.append(name)
        return int(wbad)

    # the headline group-by, as the main path calls it, five times
    head_keys = [(g_lane, 0, GROUPS)]
    head_reqs = [(None, None, "count"), (v, None, "sum")]
    nr = torch.tensor(n, dtype=torch.int64, device=dev)
    keyed("headline keyed, 5 runs", head_keys, head_reqs, GROUPS, keep, nr,
          per_thread=True, runs=5)
    ref64 = torch.zeros(GROUPS, dtype=torch.float64, device=dev).index_add_(
        0, g_lane[keep].long(), v[keep].double())
    got, _ = segment_reduce_keyed(head_keys, head_reqs, GROUPS, keep, nr)
    torch.testing.assert_close(got[1].double(), ref64, rtol=SUM_RTOL, atol=0)

    # every mode at K = 300 = 20 x 15: an INT64 key past int32 and an INT32
    # key below zero, 1% of the kept rows outside the domain, a row count
    # below the lanes' length, 10% NULL values
    m = 20_000_003

    def r():
        return torch.rand(m, device=dev, generator=gen)

    k1min, k2min = 5_000_000_000, -1000
    k1 = k1min + torch.randint(0, 20, (m,), device=dev, generator=gen)
    k2 = (k2min + torch.randint(0, 15, (m,), device=dev,
                                generator=gen)).to(torch.int32)
    k1 = torch.where(r() < 0.005, k1min - 1, k1)
    k2 = torch.where(r() < 0.005, k2min + 15, k2).to(torch.int32)
    kp = r() < 0.7
    valid = r() < 0.9
    base = torch.round(torch.randn(m, device=dev, generator=gen) * 2) / 2
    # slots of even k2 hold values <= 0 and odd ones >= 0, so +-0 decides
    # many a max and a min
    vn = torch.where(k2 % 2 == 0, -base.abs(), base.abs())
    vn = signed_zeros_and_nans(torch, vn, gen)
    vf = torch.rand(m, device=dev, generator=gen)
    iv = torch.randint(-500, 500, (m,), device=dev, generator=gen,
                       dtype=torch.int32)
    keys300 = [(k1, k1min, 20), (k2, k2min, 15)]
    every = [(None, None, "count"), (None, valid, "count"),
             ((iv > 0).to(torch.int32), None, "count"),
             (vf, valid, "sum"), (vn, None, "sum"), (iv, None, "sum"),
             (iv, valid, "min"), (iv, valid, "max"), (vn, valid, "min"),
             (vn, None, "max"), (None, None, "firstpos"),
             (None, valid, "lastpos")]
    mr = torch.tensor(m - 1234, dtype=torch.int64, device=dev)
    bad300 = keyed("every mode, K = 300, INT64 + INT32 keys, 5 runs",
                   keys300, every, 300, kp, mr, per_thread=False, runs=5)
    assert bad300 > 0, "no kept row out of the domain"
    # K = 2048 (32 x 64) with 16 requests: the per-warp instance in groups
    ka = torch.randint(0, 32, (m,), device=dev, generator=gen,
                       dtype=torch.int32)
    kb = torch.randint(-3, 67, (m,), device=dev, generator=gen)
    sixteen = (every + [(vf, None, "min"), (iv, None, "sum"),
                        (vn, valid, "max"), (vf, None, "sum")])
    keyed("K = 2048, 16 requests", [(ka, 0, 32), (kb, 0, 64)], sixteen, 2048,
          None, None, per_thread=False)
    # odd-offset views: the element-load instance of both layouts
    o = 3
    keyed("odd-offset views, per-thread", [(k2[o:], k2min, 15)],
          [(None, None, "count"), (vn[o:], valid[o:], "sum"),
           (vn[o:], None, "min")], 15, kp[o:], None, vec=False,
          per_thread=True)
    keyed("odd-offset views, per-warp", [(k1[o:], k1min, 20),
                                         (k2[o:], k2min, 15)],
          [(iv[o:], valid[o:], "max"), (vf[o:], None, "sum"),
           (None, None, "lastpos")], 300, None, m - 99, vec=False,
          per_thread=False)
    del k1, k2, kp, valid, base, vn, vf, iv, ka, kb, every, sixteen

    # the ids form (segment_reduce_multi), K = 64 and 300, every mode
    ids = torch.where(keep, g_lane, -1).to(torch.int32)
    live = (ids >= 0).to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    iv = (v * 1000).to(torch.int32) - 500
    headline = [(live, "count"), (v, "sum")]
    every = headline + [(iv, "sum"), (iv, "min"), (iv, "max"),
                        (v, "min"), (v, "max"),
                        (torch.where(ids >= 0, pos, 2 ** 31 - 1), "firstpos")]
    for K in (GROUPS, 300):
        seg = ids if K == GROUPS else torch.where(
            ids >= 0, (pos % 310) - 5, -1).to(torch.int32)
        err = max(err, seg_compare(
            torch, f"segment_reduce ids form K={K}",
            segment_reduce_multi(every, seg, K),
            segment_reduce_multi_ref(every, seg, K), every))
        names.append(f"ids form K = {K}")
    del every, pos, iv, seg
    torch.cuda.synchronize()
    # the keyed form at the headline group-by's shape: raw g (int32), keep
    # (bool), v (f32) in; count (int64) and sum (f32) of 64 slots out.  No
    # one PyTorch call counts and sums with dropped rows
    t = timings(torch,
                lambda: segment_reduce_keyed(head_keys, head_reqs, GROUPS,
                                             keep, nr),
                lambda: segment_reduce_keyed_ref(head_keys, head_reqs, GROUPS,
                                                 keep, nr), None,
                n * (4 + 1 + 4) + GROUPS * (8 + 4))
    ids_ms = cuda_ms(torch, lambda: segment_reduce_multi(headline, ids,
                                                         GROUPS))
    ids_bound = bound_ms(n * (4 + 4 + 4) + GROUPS * (8 + 4))
    log(f"kernel segment_reduce: bit-exact but f32 sums (rtol {SUM_RTOL}), "
        f"NaN slots by isnan, 5 runs bit-identical, on {len(names)} cases "
        f"({'; '.join(names)}; n={n}, max abs diff {err:.6g}); keyed form "
        f"at the headline's shape (g, keep, v -> count, sum): {t}")
    log(f"segment_reduce ids form at the headline's shape (ids, count lane, "
        f"v): ms {ids_ms:.6g}, bound_ms {ids_bound:.6g}")
    return {"max_abs_err": err, **t}


def check_segment_reduce_64(torch):
    """The segment-reduce kernel's 64-bit sum words (``sum64``) against its
    plain version.  TPC-H Q1's shape: Q1_ROWS rows of two int32 key lanes
    (3 x 2 slots, skewed as l_returnflag x l_linestatus), a keep mask
    (~98%), a device row count, five f64 value lanes (one integer-valued,
    as sum_qty: exact) summed, a count and firstpos: the per-thread
    instance, three runs bit-identical, then timed.  Then at 20M rows:
    i64 sums wrapping past INT64_MAX and i32 -> i64 widening beside the
    32-bit modes (per-thread at K = 64, i64 words by 64-bit atomics);
    f32 -> f64 widening and f64 slots holding a NaN, an inf, both
    infinities and only -0.0 (K = 300 over INT64 + INT32 keys, per-warp);
    K = 2048 with 16 requests, 64-bit and 32-bit words in groups; odd-offset
    views (element loads) of both instances.  Returns the Q1 shape's
    timings."""
    from supersonic_tpu_torch import kernels
    from supersonic_tpu_torch.kernels.segment_reduce import (
        per_thread_accumulators, segment_reduce_keyed,
        segment_reduce_keyed_ref, vector_loads)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(18)
    names, err = [], 0.0

    def keyed(name, keys, reqs, K, keep=None, num_rows=None, vec=True,
              per_thread=None, runs=2):
        nonlocal err
        # the plain version adds a slot's rows into one word (index_add_'s
        # atomics), within 2 (n - 1) 2^-53 of their sum in any order
        f64_rtol = 2 * keys[0][0].shape[0] * 2.0 ** -53
        inputs = [k for k, _, _ in keys] + ([] if keep is None else [keep])
        inputs += [t for r in reqs for t in r[:2] if t is not None]
        assert vector_loads(inputs) == vec, f"sum64 {name}: loads"
        if per_thread is not None:
            assert per_thread_accumulators(K, reqs) == per_thread, \
                f"sum64 {name}: instance"
        want, wbad = segment_reduce_keyed_ref(keys, reqs, K, keep, num_rows)
        first = None
        for run in range(runs):
            got, bad = segment_reduce_keyed(keys, reqs, K, keep, num_rows)
            assert int(bad) == int(wbad), (name, int(bad), int(wbad))
            err = max(err, seg_compare(torch, f"sum64 {name}", got, want,
                                       reqs, f64_rtol=f64_rtol))
            if first is None:
                first = got
            else:  # every output, f64 sums included, the same bits
                assert all(torch.equal(bits(a), bits(b))
                           for a, b in zip(got, first)), \
                    f"sum64 {name}: run {run + 1} differs"
        names.append(name)
        return got, want

    # TPC-H Q1's shape
    n = Q1_ROWS
    u = torch.rand(n, device=dev, generator=gen)
    rf = ((u >= 0.25).to(torch.int32) + (u >= 0.75).to(torch.int32))
    del u
    ls = torch.where(rf == 1, (torch.rand(n, device=dev, generator=gen)
                               < 0.99).to(torch.int32), 0).to(torch.int32)
    keep = torch.rand(n, device=dev, generator=gen) < 0.98
    nr = torch.tensor(n - 1001, dtype=torch.int64, device=dev)
    qty = torch.randint(1, 51, (n,), device=dev, generator=gen).double()
    price = torch.round(torch.rand(n, device=dev, generator=gen,
                                   dtype=torch.float64) * 1e7) / 100
    disc = torch.randint(0, 11, (n,), device=dev,
                         generator=gen).double() / 100
    tax = torch.randint(0, 9, (n,), device=dev, generator=gen).double() / 100
    dp = price * (1 - disc)
    charge = dp * (1 + tax)
    q1_keys = [(rf, 0, 3), (ls, 0, 2)]
    q1_reqs = [(None, None, "count"), (None, None, "firstpos")] + [
        (x, None, "sum64") for x in (qty, price, dp, charge, disc)]
    # each f64 sum also within DOUBLE_RTOL of torch.sum's tree over the
    # slot's rows (the plain version's one word a slot is the looser)
    got, want = keyed("Q1 shape, 3 runs", q1_keys, q1_reqs, 6, keep, nr,
                      per_thread=True, runs=3)
    assert torch.equal(got[2], want[2]), "sum64 Q1: sum_qty is not exact"
    ok = keep & (torch.arange(n, device=dev) < nr)
    slot = rf * 2 + ls
    q1_rel = 0.0
    for j, x in enumerate((qty, price, dp, charge, disc)):
        for s in range(6):
            tree = torch.where(ok & (slot == s), x, 0.0).sum()
            q1_rel = max(q1_rel, float((got[2 + j][s] - tree).abs() / tree))
    assert q1_rel <= DOUBLE_RTOL, f"sum64 Q1: rel diff {q1_rel:.3g}"
    want_rel = max(float(((w - g).abs() / g.abs().clamp(min=1e-300)).max())
                   for w, g in zip(want[2:], got[2:]))
    del tax, ok, slot

    # 20M rows: every other case
    m = 20_000_003

    def r():
        return torch.rand(m, device=dev, generator=gen)

    k1min, k2min = 5_000_000_000, -1000
    k1 = k1min + torch.randint(0, 20, (m,), device=dev, generator=gen)
    k2 = (k2min + torch.randint(0, 15, (m,), device=dev,
                                generator=gen)).to(torch.int32)
    k1 = torch.where(r() < 0.005, k1min - 1, k1)
    k2 = torch.where(r() < 0.005, k2min + 15, k2).to(torch.int32)
    kp = r() < 0.7
    valid = r() < 0.9
    g64 = torch.randint(0, 64, (m,), device=dev, generator=gen,
                        dtype=torch.int32)
    big = torch.randint(2 ** 61, 2 ** 63 - 1, (m,), device=dev,
                        generator=gen)
    iv = torch.randint(2 ** 30, 2 ** 31 - 1, (m,), device=dev, generator=gen,
                       dtype=torch.int32)
    fv = torch.rand(m, device=dev, generator=gen)
    dv = torch.rand(m, device=dev, generator=gen, dtype=torch.float64)
    got, _ = keyed("i64 wrap and i32 widening, K = 64, per-thread",
                   [(g64, 0, 64)],
                   [(big, valid, "sum64"), (iv, None, "sum64"),
                    (None, None, "count"), (fv, None, "sum"),
                    (iv, valid, "max"), (dv, None, "sum64")], 64, kp,
                   m - 77, per_thread=True)
    exact = torch.zeros(64, dtype=torch.float64, device=dev).index_add_(
        0, g64[kp].long(), big[kp].double() * valid[kp])
    assert bool((exact > 2.0 ** 63).any()), "sum64: no i64 sum wraps"
    # an f64 lane whose slots 0, 1 and 2 hold a NaN, an inf and both
    # infinities in counted rows, and slot 4 only -0.0; the other values
    # positive
    slot = (k1 - k1min) * 15 + (k2.long() - k2min)
    live = kp & valid & (torch.arange(m, device=dev) < m - 1234)

    def rows_of(s, k):
        return torch.nonzero((slot == s) & live)[:k, 0]

    dn = dv.clone()
    dn[rows_of(0, 1)] = float("nan")
    dn[rows_of(1, 1)] = float("inf")
    dn[rows_of(2, 2)] = torch.tensor([float("inf"), float("-inf")],
                                     dtype=torch.float64, device=dev)
    dn = torch.where(slot == 4, torch.full_like(dn, -0.0), dn)
    keys300 = [(k1, k1min, 20), (k2, k2min, 15)]
    every = [(None, None, "count"), (None, valid, "count"),
             (dn, valid, "sum64"), (fv, None, "sum64"), (big, None, "sum64"),
             (iv, valid, "sum64"), (fv, valid, "sum"), (iv, None, "sum"),
             (iv, valid, "min"), (fv, None, "max"), (None, None, "firstpos"),
             (None, valid, "lastpos")]
    mr = torch.tensor(m - 1234, dtype=torch.int64, device=dev)
    got, want = keyed("every mode, K = 300, INT64 + INT32 keys, per-warp",
                      keys300, every, 300, kp, mr, per_thread=False)
    for x in (got[2], want[2]):
        assert bool(x[0].isnan()) and bool(x[1] == float("inf")) and \
            bool(x[2].isnan()), "sum64: the non-finite slots"
        assert bool(x[4] == 0) and not bool(torch.signbit(x[4])), \
            "sum64: a slot of -0.0 rows is not +0.0"
    ka = torch.randint(0, 32, (m,), device=dev, generator=gen,
                       dtype=torch.int32)
    kb = torch.randint(-3, 67, (m,), device=dev, generator=gen)
    sixteen = every + [(dv, None, "sum64"), (big, valid, "sum64"),
                       (fv, None, "min"), (dv, valid, "sum64")]
    keyed("K = 2048, 16 requests, 64-bit and 32-bit words in groups",
          [(ka, 0, 32), (kb, 0, 64)], sixteen, 2048, None, None,
          per_thread=False)
    o = 3
    keyed("odd-offset views, per-thread", [(k2[o:], k2min, 15)],
          [(None, None, "count"), (dv[o:], valid[o:], "sum64"),
           (iv[o:], None, "sum64"), (fv[o:], None, "sum64")], 15, kp[o:],
          None, vec=False, per_thread=True)
    keyed("odd-offset views, per-warp", [(k1[o:], k1min, 20),
                                         (k2[o:], k2min, 15)],
          [(big[o:], valid[o:], "sum64"), (dv[o:], None, "sum64"),
           (None, None, "lastpos")], 300, None, m - 99, vec=False,
          per_thread=False)
    del k1, k2, kp, valid, g64, big, iv, fv, dv, dn, slot, live, ka, kb
    del every
    del sixteen
    torch.cuda.synchronize()

    # timed at Q1's shape: rf, ls (int32), keep (bool), five f64 lanes in;
    # a count (int64), firstpos (int32) and five f64 sums of 6 slots out
    kernels.reset_launches()
    segment_reduce_keyed(q1_keys, q1_reqs, 6, keep, nr)
    launched = dict(kernels.launches)
    t = timings(torch,
                lambda: segment_reduce_keyed(q1_keys, q1_reqs, 6, keep, nr),
                lambda: segment_reduce_keyed_ref(q1_keys, q1_reqs, 6, keep,
                                                 nr), None,
                n * (4 + 4 + 1 + 5 * 8) + 6 * (8 + 4 + 5 * 8))
    t["launches"] = launched["segment_reduce"]
    t["rel_err_vs_tree"] = q1_rel
    t["plain_rel_diff"] = want_rel
    log(f"kernel segment_reduce 64-bit words: bit-exact but f64 sums (rtol "
        f"{DOUBLE_RTOL}; Q1's integer-valued sum exact), NaN slots by isnan, "
        f"runs bit-identical, on {len(names)} cases ({'; '.join(names)}; "
        f"max abs diff {err:.6g}); at Q1's shape (n={n}: rf, ls, keep, 5 "
        f"f64 lanes -> count, firstpos, 5 f64 sums of 6 slots): {t}")
    return {"max_abs_err": err, **t}


def check_segment_reduce_small(torch, ids, v):
    """One request of the segment-reduce kernel, at the headline group-by's
    shape with every id in range (so index_add_ computes the same sum)."""
    from supersonic_tpu_torch.kernels.segment_reduce import (
        segment_reduce_small, segment_reduce_small_ref)

    n = ids.shape[0]
    iv = (v * 1000).to(torch.int32) - 500
    err = 0.0
    for vals, mode in ((v, "sum"), (v, "min"), (v, "max"), (iv, "sum"),
                       (iv, "min"), (iv, "max")):
        a = segment_reduce_small(vals, ids, GROUPS, mode)
        b = segment_reduce_small_ref(vals, ids, GROUPS, mode)
        if mode == "sum" and vals.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=SUM_RTOL, atol=0)
        else:
            assert torch.equal(bits(a), bits(b)), \
                f"segment_reduce_small {mode}"
        err = max(err, max_abs_diff(a, b))
    torch.cuda.synchronize()
    t = timings(torch, lambda: segment_reduce_small(v, ids, GROUPS, "sum"),
                lambda: segment_reduce_small_ref(v, ids, GROUPS, "sum"),
                lambda: torch.zeros(GROUPS, device="cuda").index_add_(0, ids,
                                                                      v),
                n * (4 + 4) + GROUPS * 4)
    log(f"kernel segment_reduce_small: sum/min/max of f32 and i32, integer "
        f"results and f32 min/max exact, f32 sums within rtol {SUM_RTOL} "
        f"(n={n}, K={GROUPS}, max abs diff {err:.6g}); {t}")
    return {"max_abs_err": err, **t}


def check_spread(torch, v):
    """The spread kernel at the dup8 join's shape (12.5M sources of v and
    d, 8 rows each, into 100M rows), then bit for bit on the edge cases:
    payloads of every width with a dead tail, out_cap below the total, no
    source, repeated starts, starts on tile edges, a tile's run of exactly
    the stage and one past it (the searched route), the row add beside 1-,
    2- and 8-byte lanes, and views at odd offsets; then timed at (a)'s and
    (b)'s shapes."""
    from supersonic_tpu_torch.kernels import library
    from supersonic_tpu_torch.kernels.spread import (I32_MAX, spread_kernel,
                                                     spread_ref)

    dev = v.device
    g = torch.Generator(device="cuda").manual_seed(11)
    n = v.shape[0]
    eff8 = torch.full((n,), 8, dtype=torch.int64, device=dev)
    base8 = torch.arange(n, dtype=torch.int32, device=dev) * 8
    d = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32, device=dev,
                      generator=g)

    def runs(m, max_eff, dead=0):
        eff = torch.randint(1, max_eff + 1, (m,), device=dev, generator=g)
        base = torch.cat([(torch.cumsum(eff, 0) - eff).to(torch.int32),
                          torch.full((dead,), I32_MAX, dtype=torch.int32,
                                     device=dev)])
        return base, int(eff.sum())

    def rand(m, dtype):
        if dtype == torch.bool:
            return torch.rand(m, device=dev, generator=g) < 0.5
        if dtype.is_floating_point:
            return torch.randn(m, device=dev, generator=g, dtype=dtype)
        return torch.randint(-2**15, 2**15, (m,), device=dev, generator=g,
                             dtype=dtype)

    cases = [("main", [v, d], base8, DUP_OUT, (1,))]
    bw, tw = runs(1_000_003, 8, dead=1000)
    wide = [rand(bw.shape[0], t) for t in (torch.bool, torch.int16,
                                            torch.float32, torch.float64,
                                            torch.int64)]
    cases += [("1/2/4/8-byte payloads, dead tail", wide, bw, tw + 5000, ()),
              ("out_cap < total", wide, bw, tw // 2 + 7, ())]
    b1, t1 = runs(4_000_000, 1)
    cases.append(("max_eff 1", [rand(b1.shape[0], torch.int32)], b1, t1,
                  (0,)))
    bk, tk = runs(100_000, 1000)
    cases.append(("max_eff 1000", [rand(bk.shape[0], torch.float32)], bk, tk,
                  ()))
    cases.append(("n_src 0", [torch.zeros(0, dtype=torch.int32, device=dev)],
                  torch.zeros(0, dtype=torch.int32, device=dev), 4096, ()))
    rep = torch.sort(torch.randint(0, 100_000, (1_000_000,), device=dev,
                                   generator=g)).values.to(torch.int32)
    rep[0] = 0
    cases.append(("repeated starts", [rand(rep.shape[0], torch.int64)], rep,
                  100_077, ()))
    tile = library().ss_spread_tile_rows()
    # sources starting exactly on tile edges and one row either side
    edge = torch.tensor([tile, 1, tile - 2, 1, tile], device=dev).repeat(
        2000)
    be = (torch.cumsum(edge, 0) - edge).to(torch.int32)
    assert bool((be % tile == 0).any()) and bool((be % tile == 1).any())
    cases.append(("starts on tile edges", [rand(be.shape[0], t) for t in (
        torch.int32, torch.float64)], be, int(edge.sum()), (0,)))
    # tile 1's run: one source before it, `run - 2` sharing one start, one
    # at its last row; the stage holds exactly tile + 2 sources
    for run in (tile + 2, tile + 3):
        br = torch.cat([torch.tensor([0, tile], device=dev),
                        torch.full((run - 2,), tile + 900, device=dev),
                        torch.tensor([2 * tile - 1], device=dev),
                        torch.arange(2 * tile, 6 * tile, 3, device=dev)]
                       ).to(torch.int32)
        cases.append((f"a run of {run} sources in one tile",
                      [rand(br.shape[0], torch.int32)], br, 6 * tile + 5,
                      (0,)))
    mixed = [rand(bw.shape[0], t) for t in (torch.bool, torch.int16,
                                            torch.int32, torch.float64)]
    cases.append(("row add on a 4-byte lane beside 1-, 2-, 8-byte lanes",
                  mixed, bw, tw, (2,)))
    # views at odd offsets: base one int32 in, payloads 1 or 3 elements in
    bo = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), bw])[1:]
    odd = [rand(bw.shape[0] + k, t)[k:] for k, t in (
        (3, torch.bool), (1, torch.int16), (1, torch.int32),
        (1, torch.float64))]
    assert all(p.data_ptr() % 16 for p in odd + [bo])
    cases.append(("odd-offset views", odd, bo, tw + 3, (2,)))
    err = 0.0
    for name, pays, base, cap, add_row in cases:
        got = spread_kernel(pays, base, cap, add_row)
        want = spread_ref(pays, base, cap, add_row)
        for a, b in zip(got, want):
            assert a.shape[0] == cap and torch.equal(bits(a), bits(b)), \
                f"spread {name}"
            err = max(err, max_abs_diff(a, b))
    lib = [torch.repeat_interleave(p, eff8, output_size=DUP_OUT)
           for p in (v, d)]
    assert all(torch.equal(bits(a), bits(b)) for a, b in
               zip(spread_kernel([v, d], base8, DUP_OUT), lib)), \
        "spread: repeat_interleave disagrees"
    del lib
    torch.cuda.synchronize()
    # as the join calls it: d comes out as the build position j + d; the
    # library call expands without that add
    t = timings(torch, lambda: spread_kernel([v, d], base8, DUP_OUT, (1,)),
                lambda: spread_ref([v, d], base8, DUP_OUT, (1,)),
                lambda: [torch.repeat_interleave(p, eff8, output_size=DUP_OUT)
                         for p in (v, d)],
                n * (4 + 4 + 4) + DUP_OUT * (4 + 4))
    bare = cuda_ms(torch, lambda: spread_kernel([v, d], base8, DUP_OUT))
    names = [c[0] for c in cases]
    del cases, got, want
    log(f"kernel spread: bit-exact on {len(names)} cases ({n} sources into "
        f"{DUP_OUT} rows; {'; '.join(names)}; row index added to d in main "
        f"and wherever a case adds it); {t}; without the row add "
        f"{bare:.6f} ms")
    # each call shape of the joins: (a) as above; (b) LEFT_OUTER under
    # Filter(v > 0.5): about half the sources live, half of those hit their
    # key's 8 rows and half emit one NULL row, then dead sources; three
    # lanes (v, d + row, count) into the plan's 100M rows, rows past the
    # total holding the last live source.  Bounds count the live sources.
    live = v > 0.5
    eff = torch.where(torch.rand(n, device=dev, generator=g) < 0.5, 8, 1)
    eff = eff[live]
    nb = eff.shape[0]
    bb = torch.cat([(torch.cumsum(eff, 0) - eff).to(torch.int32),
                    torch.full((n - nb,), I32_MAX, dtype=torch.int32,
                               device=dev)])
    cnt = torch.cat([eff.to(torch.int32),
                     torch.zeros(n - nb, dtype=torch.int32, device=dev)])
    pays_b = [v, d, cnt]
    per_call = [{"call": "(a) v, d + row", "sources": n, "live": n,
                 "rows": DUP_OUT, "lanes": 2, "ms": t["ms"],
                 "bound_ms": t["bound_ms"]}]
    ms = cuda_ms(torch, lambda: spread_kernel(pays_b, bb, DUP_OUT, (1,)))
    per_call.append({"call": "(b) v, d + row, count", "sources": n,
                     "live": nb, "rows": DUP_OUT, "total": int(eff.sum()),
                     "lanes": 3, "ms": ms,
                     "bound_ms": bound_ms(nb * (4 + 12) + DUP_OUT * 12)})
    for c in per_call:
        c["over_bound_ms"] = c["ms"] - c["bound_ms"]
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(
        spread_kernel(pays_b, bb, DUP_OUT, (1,)),
        spread_ref(pays_b, bb, DUP_OUT, (1,)))), "spread: (b)'s shape"
    log(f"spread per call shape: {json.dumps(per_call)}")
    return {"max_abs_err": err, **t}


def merge_data(torch, dev):
    """Path (d)'s runs: bench_ops.py:283-294's data from default_rng(42) at
    50M rows a run, with about 1% of v set to zeros of both signs; each run
    sorted by (g ASC, v DESC) with a stable sort of a packed key on the
    card.  The packed key is g in the high word and, in the low word,
    0x3F800000 minus v's bits (v in [0, 1), -0 made +0): it orders exactly
    as the plan's keys.  Returns per run (g, v, packed), sorted, on the
    card."""
    rng = np.random.default_rng(42)
    n = MERGE_RUN_ROWS
    gs = [rng.integers(0, 64, n).astype(np.int32) for _ in range(2)]
    vs = [rng.random(n, dtype=np.float32) for _ in range(2)]
    runs = []
    for g, v in zip(gs, vs):
        z = rng.random(n) < 0.01
        v[z] = np.where(rng.random(int(z.sum())) < 0.5, np.float32(-0.0),
                        np.float32(0.0))
        g, v = torch.from_numpy(g).to(dev), torch.from_numpy(v).to(dev)
        desc = 0x3F800000 - (v + 0.0).view(torch.int32).to(torch.int64)
        packed = (g.to(torch.int64) << 32) | desc
        packed, perm = torch.sort(packed, stable=True)
        runs.append((g[perm], v[perm], packed))
    return runs


def merge_tables(T, runs, dev):
    """Path (d)'s two sorted runs as tables (g INT32, v FLOAT) on ``dev``."""
    ms = T.TupleSchema.of(("g", T.INT32, False), ("v", T.FLOAT, False))
    return [T.Table.from_numpy(ms, {"g": g.cpu().numpy(),
                                    "v": v.cpu().numpy()}, device=dev)
            for g, v, _ in runs]


def merge_plan(T, tables):
    """bench_ops.py:296-299's plan: MergeUnionAll by (g ASC, v DESC)."""
    return T.MergeUnionAll([("g", True), ("v", False)],
                           [T.ScanTable(t) for t in tables])


def merge_ranks(torch, packed):
    """Output row of every row of each sorted run under a stable k-way merge
    (ties: earlier run first), from searchsorted on the packed keys."""
    ranks = []
    for r, p in enumerate(packed):
        rank = torch.arange(p.shape[0], device=p.device)
        for s_, q in enumerate(packed):
            if s_ != r:
                rank += torch.searchsorted(q, p, right=s_ < r)
        ranks.append(rank)
    return ranks


def merge4_data(torch, dev):
    """Path (e)'s four 25M-row runs, made on the card from a seeded
    generator: k INT64 in [0, 2^20), 5% NULL; d DOUBLE on a quarter grid
    (ties, and -0.0 from rounding), 0.2% NaN and 0.2% NaN with the sign bit
    set; s STRING codes into a per-run dictionary of 1000 words (run r holds
    words 250 r .. 250 r + 999).  Each run sorted by (k ASC NULL first, d
    DESC NaN last) with a stable sort of a packed key: null rank, k, then
    the descending rank of d's quarter count 4 d (NaN after all)."""
    g = torch.Generator(device=dev).manual_seed(43)
    n = MERGE4_RUN_ROWS
    qnan, neg_qnan = 0x7FF8000000000000, -0x0008000000000000  # f64 bits
    runs = []
    for r in range(4):
        k = torch.randint(0, 1 << 20, (n,), device=dev, generator=g)
        kvalid = torch.rand(n, device=dev, generator=g) >= 0.05
        d = torch.round(torch.randn(n, device=dev, generator=g,
                                    dtype=torch.float64) * 8) / 4
        u = torch.rand(n, device=dev, generator=g)
        # NaNs set by their bits: a float NaN operand may lose its sign
        d = torch.where(u < 0.002, qnan, torch.where(
            u < 0.004, neg_qnan, d.view(torch.int64))).view(torch.float64)
        codes = torch.randint(0, 1000, (n,), device=dev, generator=g,
                              dtype=torch.int32)
        isnan = d.isnan()
        rank = torch.where(isnan, (1 << 21) - 1, (1 << 20) - torch.where(
            isnan, 0, d * 4).to(torch.int64))
        packed = torch.where(kvalid, (1 << 62) | (k << 21) | rank, rank)
        packed, perm = torch.sort(packed, stable=True)
        runs.append({"k": k[perm], "kvalid": kvalid[perm], "d": d[perm],
                     "s": codes[perm], "packed": packed,
                     "words": [f"w{j:06d}" for j in range(250 * r,
                                                          250 * r + 1000)]})
    return runs


def merge4_tables(T, runs, dev):
    """Path (e)'s four sorted runs as tables (k INT64 nullable, d DOUBLE,
    s STRING with the run's dictionary) on ``dev``."""
    s4 = T.TupleSchema.of(("k", T.INT64, True), ("d", T.DOUBLE, False),
                          ("s", T.STRING, False))
    return [T.Table.from_numpy(
        s4, {"k": (r["k"].cpu().numpy(), r["kvalid"].cpu().numpy()),
             "d": r["d"].cpu().numpy(), "s": r["s"].cpu().numpy()},
        dicts={"s": T.Dictionary(tuple(r["words"]))}, device=dev)
        for r in runs]


def merge4_plan(T, tables):
    """Path (e)'s plan: MergeUnionAll by (k ASC, d DESC)."""
    return T.MergeUnionAll([("k", True), ("d", False)],
                           [T.ScanTable(t) for t in tables])


def sorted_side(torch, lanes, keys):
    """The lanes of one merge side in the merge order of ``keys`` (stable
    passes over the plain version's compare words)."""
    from supersonic_tpu_torch.kernels.merge_sorted import coded_words

    perm = torch.arange(lanes[0].shape[0], device=lanes[0].device)
    for w in reversed(coded_words(lanes, keys)):
        perm = perm[torch.sort(w[perm], stable=True).indices]
    return [x[perm] for x in lanes]


def check_merge_sorted(torch, runs):
    """The merge kernel bit for bit against merge_sorted_ref on the card:
    at path (d)'s shape (2 x 50M rows, keys g ASC and v DESC over the raw
    columns g INT32 and v FLOAT with zeros of both signs), then heavy ties,
    uneven and empty sides, sides of whole tiles, live counts below
    capacity, out_cap equal to the live total, int32 and int64 keys, 16 keys
    with 40 more lanes (two merge launches), lanes of 1, 2, 4 and 8 bytes;
    float32 and float64 keys ASC and DESC with NaNs of both signs and +-0,
    nullable int64 keys ASC and DESC, a bool key and a nullable STRING code
    key DESC."""
    from supersonic_tpu_torch.kernels.merge_sorted import (MergeKey,
                                                           merge_sorted,
                                                           merge_sorted_ref,
                                                           tile_rows)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cuda").manual_seed(13)
    (ga, va, pa), (gb, vb, pb) = runs
    n = ga.shape[0]
    key0 = [MergeKey(0)]
    d_keys = [MergeKey(0, True), MergeKey(1, False)]

    def lane(m, distinct, dtype=torch.int32, ordered=True):
        x = torch.randint(0, distinct, (m,), device=dev, generator=g)
        return (torch.sort(x).values if ordered else x).to(dtype)

    def rand(m, dtype):
        if dtype == torch.bool:
            return torch.rand(m, device=dev, generator=g) < 0.5
        if dtype.is_floating_point:
            return torch.randn(m, device=dev, generator=g, dtype=dtype)
        return torch.randint(-2**15, 2**15, (m,), device=dev, generator=g,
                             dtype=dtype)

    def rows(x):
        return torch.full((), x, dtype=torch.int64, device=dev)

    # (name, a_lanes, b_lanes, keys, out_cap, a_rows, b_rows)
    cases = [("main", [ga, va], [gb, vb], d_keys, 2 * n, None, None)]
    ta, tb = lane(n, 5), lane(n, 5)
    cases.append(("5 distinct keys", [ta, rand(n, torch.int32)],
                  [tb, rand(n, torch.int32)], key0, 2 * n, None, None))
    del ta, tb
    u = lane(70_000_000, 10**6)
    cases.append(("70M against 3", [u, rand(u.shape[0], torch.float32)],
                  [lane(3, 10**6), rand(3, torch.float32)], key0,
                  u.shape[0] + 3, None, None))
    e = lane(1_000_003, 100)
    cases.append(("empty side", [e, rand(e.shape[0], torch.int64)],
                  [lane(0, 100), rand(0, torch.int64)], key0, e.shape[0],
                  None, None))
    cases.append(("empty side first", [lane(0, 100), rand(0, torch.int64)],
                  [e, rand(e.shape[0], torch.int64)], key0, e.shape[0], None,
                  rows(e.shape[0] - 5)))
    m = tile_rows([e], key0) * 977
    cases.append(("whole tiles", [lane(m, 37), rand(m, torch.int32)],
                  [lane(m, 37), rand(m, torch.int32)], key0, 2 * m, None,
                  None))
    cap = 1_000_000
    dead = [torch.cat([lane(live, 1000), lane(cap - live, 1000,
                                              ordered=False)])
            for live in (700_001, 333_333)]
    cases.append(("live counts below capacity",
                  [dead[0], rand(cap, torch.int16)],
                  [dead[1], rand(cap, torch.int16)], key0, 2 * cap,
                  rows(700_001), rows(333_333)))
    cases.append(("out_cap = live total", [dead[0], rand(cap, torch.int32)],
                  [dead[1], rand(cap, torch.int32)], key0,
                  700_001 + 333_333, rows(700_001), rows(333_333)))

    def two_lanes(m):
        hi = torch.randint(0, 50, (m,), device=dev, generator=g,
                           dtype=torch.int32)
        lo = torch.randint(-2**62, 2**62, (m,), device=dev, generator=g)
        lo = torch.where(torch.rand(m, device=dev, generator=g) < 0.5,
                         lo % 7, lo)  # ties on both keys
        return sorted_side(torch, [hi, lo, rand(m, torch.int32)],
                           [MergeKey(0), MergeKey(1)])

    cases.append(("int32 + int64 keys", two_lanes(2_000_000),
                  two_lanes(1_500_000), [MergeKey(0), MergeKey(1)],
                  3_500_000, rows(1_999_000), None))
    keys16 = [MergeKey(i) for i in range(16)]

    def many_lanes(m):  # 16 keys of 3 values: ties down to the last
        lanes = [torch.randint(0, 3, (m,), device=dev, generator=g,
                               dtype=torch.int32 if i % 2 else torch.int64)
                 for i in range(16)]
        return sorted_side(torch, lanes, keys16) + [
            rand(m, torch.int32) for _ in range(40)]

    cases.append(("16 keys, 40 more lanes", many_lanes(300_000),
                  many_lanes(200_001), keys16, 500_001, rows(299_999), None))
    widths = (torch.bool, torch.int16, torch.float32, torch.float64,
              torch.int64)
    cases.append(("1/2/4/8-byte lanes",
                  [lane(2_000_000, 1000)] + [rand(2_000_000, t)
                                             for t in widths],
                  [lane(1_000_000, 1000)] + [rand(1_000_000, t)
                                             for t in widths], key0,
                  3_000_000, None, None))

    def floats(m, dtype):
        """Quarter steps with ties; 2% NaN, 2% -NaN and 5% -0.0, set by
        their bits (a float NaN operand may lose its sign)."""
        x = torch.round(torch.randn(m, device=dev, generator=g,
                                    dtype=dtype) * 8) / 4
        r = torch.rand(m, device=dev, generator=g)
        ib, qnan, neg_qnan, neg_zero = (
            (torch.int32, 0x7FC00000, -0x00400000, -2**31)
            if dtype == torch.float32 else
            (torch.int64, 0x7FF8000000000000, -0x0008000000000000, -2**63))
        return torch.where(r < 0.02, qnan, torch.where(
            r < 0.04, neg_qnan, torch.where(r < 0.09, neg_zero, x.view(
                ib)))).view(dtype)

    for dtype in (torch.float32, torch.float64):
        for asc in (True, False):
            fk = [MergeKey(0, asc)]
            cases.append((f"{dtype} key {'ASC' if asc else 'DESC'}",
                          sorted_side(torch, [floats(1_500_000, dtype),
                                              rand(1_500_000, torch.int32)],
                                      fk),
                          sorted_side(torch, [floats(1_000_001, dtype),
                                              rand(1_000_001, torch.int32)],
                                      fk), fk, 2_500_001, None, None))

    def nullable(m, values, nulls=0.1):
        ok = torch.rand(m, device=dev, generator=g) >= nulls
        return [values, ok, rand(m, torch.float64)]

    for asc in (True, False):
        nk = [MergeKey(0, asc, 1)]
        cases.append((f"nullable int64 key {'ASC' if asc else 'DESC'}",
                      sorted_side(torch, nullable(2_000_000, torch.randint(
                          -2**40, 2**40, (2_000_000,), device=dev,
                          generator=g) % 1000), nk),
                      sorted_side(torch, nullable(1_200_000, torch.randint(
                          -2**40, 2**40, (1_200_000,), device=dev,
                          generator=g) % 1000), nk), nk, 3_200_000,
                      rows(1_999_999), None))
    bk = [MergeKey(0, False), MergeKey(1, True)]
    cases.append(("bool key DESC, then int32",
                  sorted_side(torch, [rand(1_000_000, torch.bool),
                                      lane(1_000_000, 50, ordered=False)],
                              bk),
                  sorted_side(torch, [rand(900_000, torch.bool),
                                      lane(900_000, 50, ordered=False)], bk),
                  bk, 1_900_000, None, None))
    sk = [MergeKey(0, False, 1)]
    cases.append(("nullable STRING code key DESC",
                  sorted_side(torch, nullable(1_000_000, lane(
                      1_000_000, 4000, ordered=False), 0.2), sk),
                  sorted_side(torch, nullable(800_000, lane(
                      800_000, 4000, ordered=False), 0.2), sk), sk,
                  1_800_000, None, None))
    err = 0.0
    for name, al, bl, keys, oc, ar, br in cases:
        got = merge_sorted(al, bl, keys, oc, ar, br)
        want = merge_sorted_ref(al, bl, keys, oc, ar, br)
        for a, b in zip(got, want):
            assert a.shape[0] == oc and torch.equal(bits(a), bits(b)), \
                f"merge_sorted {name}"
            err = max(err, max_abs_diff(a, b))
    names = [c[0] for c in cases]
    del cases, got, want, u, e, dead
    torch.cuda.synchronize()
    # the library call: one stable sort of the concatenation's packed key,
    # then one index_select per column
    packed = torch.cat([pa, pb])
    cat = [torch.cat([ga, gb]), torch.cat([va, vb])]

    def library_call():
        idx = torch.sort(packed, stable=True).indices
        return [p.index_select(0, idx) for p in cat]

    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(
        merge_sorted([ga, va], [gb, vb], d_keys, 2 * n), library_call())), \
        "merge_sorted: the packed-key sort disagrees"
    ins = [ga, va, gb, vb]
    out = merge_sorted(ins[:2], ins[2:], d_keys, 2 * n)
    t = timings(torch, lambda: merge_sorted(ins[:2], ins[2:], d_keys, 2 * n),
                lambda: merge_sorted_ref(ins[:2], ins[2:], d_keys, 2 * n),
                library_call, moved_bytes(ins, out))
    del out
    log(f"kernel merge_sorted: bit-exact on {len(names)} cases "
        f"({'; '.join(names)}; main: 2 x {n} rows as path (d)'s fold step "
        f"calls it); {t}")
    return {"max_abs_err": err, **t}


def fold_steps_e(torch, kernels, m4_t):
    """Path (e)'s three fold steps as MergeUnionAll makes them, each on the
    lanes (k, k's validity, d, s) of the runs: time, byte bound and
    launches of each."""
    from supersonic_tpu_torch.kernels.merge_sorted import (MergeKey,
                                                           merge_sorted)

    keys = [MergeKey(0, True, 1), MergeKey(2, False)]
    runs = [[t.columns["k"].values, t.columns["k"].valid,
             t.columns["d"].values, t.columns["s"].values] for t in m4_t]
    acc = runs[0]
    steps = []
    for i, run in enumerate(runs[1:]):
        cap = acc[0].shape[0] + run[0].shape[0]
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = merge_sorted(acc, run, keys, cap)
        torch.cuda.synchronize()
        launched = kernels.launches["merge_sorted"]
        a = acc
        ms = cuda_ms(torch, lambda: merge_sorted(a, run, keys, cap))
        bound = bound_ms(moved_bytes(acc + run, out))
        steps.append({"step": i + 1, "rows": cap, "ms": ms,
                      "bound_ms": bound, "launches": launched})
        acc = out
    log(f"(e) fold steps, merge_sorted as MergeUnionAll calls it "
        f"(keys k INT64 nullable ASC, d DOUBLE DESC; lanes k, k valid, d, "
        f"s): {json.dumps(steps)}")
    return steps


def check_merge_d(torch, out, runs):
    """Path (d): 100M rows in exact merge order: each run's rows at their
    searchsorted ranks."""
    total = sum(r[0].shape[0] for r in runs)
    assert int(out.num_rows) == total, "(d): row count"
    ranks = merge_ranks(torch, [r[2] for r in runs])
    for col, i in (("g", 0), ("v", 1)):
        want = torch.empty(total, dtype=runs[0][i].dtype, device=out.device)
        for run, rank in zip(runs, ranks):
            want[rank] = run[i]
        assert out.columns[col].valid is None
        assert torch.equal(bits(out.columns[col].values[:total]),
                           bits(want)), f"(d): column {col}"
    return total


def check_merge_e(torch, out, runs):
    """Path (e): 100M rows in exact merge order (NULL k first, NaN d last,
    ties by run), d bit for bit (NaN signs kept), k and its NULLs, and s
    remapped into the merged dictionary."""
    dev = out.device
    total = sum(r["k"].shape[0] for r in runs)
    assert int(out.num_rows) == total, "(e): row count"
    merged = sorted(set().union(*[r["words"] for r in runs]))
    assert out.dicts["s"].values == tuple(merged), "(e): dictionary"
    ranks = merge_ranks(torch, [r["packed"] for r in runs])
    want = {c: torch.empty(total, dtype=runs[0][c].dtype, device=dev)
            for c in ("k", "kvalid", "d", "s")}
    for run, rank in zip(runs, ranks):
        for c in ("k", "kvalid", "d"):
            want[c][rank] = run[c]
        remap = torch.from_numpy(np.searchsorted(merged, run["words"])).to(
            dev)
        want["s"][rank] = remap[run["s"].long()].to(torch.int32)
    k = out.columns["k"]
    valid = want["kvalid"]
    assert torch.equal(k.valid[:total], valid), "(e): NULLs of k"
    assert torch.equal(torch.where(valid, k.values[:total], 0),
                       torch.where(valid, want["k"], 0)), "(e): column k"
    d = out.columns["d"].values[:total]
    assert torch.equal(bits(d), bits(want["d"])), "(e): column d"
    assert torch.equal(out.columns["s"].values[:total], want["s"]), \
        "(e): column s"
    nan = want["d"].isnan()
    assert bool(torch.signbit(want["d"][nan]).any()), "(e): no -NaN"
    return total, int((~valid).sum()), int(nan.sum())


def check_union(torch, out, runs):
    """UnionAll of path (e)'s runs: the runs one after another, s remapped
    into the merged dictionary."""
    total = sum(r["k"].shape[0] for r in runs)
    assert int(out.num_rows) == total, "UnionAll: row count"
    merged = sorted(set().union(*[r["words"] for r in runs]))
    assert out.dicts["s"].values == tuple(merged), "UnionAll: dictionary"
    remaps = [torch.from_numpy(np.searchsorted(merged, r["words"])).to(
        out.device)[r["s"].long()].to(torch.int32) for r in runs]
    valid = torch.cat([r["kvalid"] for r in runs])
    k = out.columns["k"]
    assert torch.equal(k.valid[:total], valid), "UnionAll: NULLs of k"
    assert torch.equal(torch.where(valid, k.values[:total], 0), torch.where(
        valid, torch.cat([r["k"] for r in runs]), 0)), "UnionAll: column k"
    assert torch.equal(bits(out.columns["d"].values[:total]),
                       bits(torch.cat([r["d"] for r in runs]))), \
        "UnionAll: column d"
    assert torch.equal(out.columns["s"].values[:total], torch.cat(remaps)), \
        "UnionAll: column s"


def check_headline(out, fact, dim):
    """Rows of the headline query against a float64 numpy computation
    (bench.py:42-52).  Groups and counts match exactly.  Sums match within
    rtol 1e-4: the port accumulates in f32 (SUM keeps the input type, as
    the reference does), about 780k rows per group at 100M rows, in the
    kernel's fixed order."""
    keep = fact["v"] > 0.5
    g = dim["g"][fact["fk"][keep]]
    sums = np.bincount(g, weights=fact["v"][keep].astype(np.float64),
                       minlength=GROUPS)
    counts = np.bincount(g, minlength=GROUPS)
    rows = out.to_pylist()
    assert [a.name for a in out.schema] == ["g", "sv", "c"]
    got = {r[0]: (r[1], r[2]) for r in rows}
    want = {int(k): (sums[k], int(counts[k])) for k in np.nonzero(counts)[0]}
    assert sorted(got) == sorted(want), "headline: group keys differ"
    for k, (sv, c) in want.items():
        assert got[k][1] == c, f"headline: count of group {k}"
        np.testing.assert_allclose(got[k][0], sv, rtol=SUM_RTOL)
    svs = [r[1] for r in rows]
    assert all(a >= b for a, b in zip(svs, svs[1:])), "sv must not increase"
    return len(rows)


def check_dup8_inner(torch, out, fact, dim):
    """Run (a): 100M rows in (lhs row, rhs original order): fact row i
    meets dim rows 8 fk[i] .. 8 fk[i] + 7."""
    assert int(out.num_rows) == DUP_OUT, "(a): row count"
    assert out.columns["w"].valid is None and out.columns["v"].valid is None
    for col, want in (("v", np.repeat(fact["v"], 8)),
                      ("w", dim["w"].reshape(-1, 8)[fact["fk"]].ravel())):
        got = out.columns[col].values[:DUP_OUT]
        assert torch.equal(bits(got), bits(torch.from_numpy(want).to(
            got.device))), f"(a): column {col}"


def check_dup8_left_outer(torch, out, fact, dim):
    """Run (b): every kept row (v > 0.5) gets its key's 8 dim rows, or one
    row with a NULL w when its key is past the dim's.  Returns (rows,
    NULL rows)."""
    keep = fact["v"] > 0.5
    k = fact["fk"][keep].astype(np.int64)
    hit = k < DUP_KEYS
    eff = np.where(hit, 8, 1)
    n = int(eff.sum())
    assert int(out.num_rows) == n, "(b): row count"
    first = np.repeat(np.cumsum(eff) - eff, eff)
    valid = np.repeat(hit, eff)
    w_idx = np.repeat(8 * k, eff) + (np.arange(n) - first)
    want_w = np.where(valid, dim["w"][np.where(valid, w_idx, 0)], 0)
    v = out.columns["v"].values[:n]
    w = out.columns["w"]
    dev = v.device
    assert torch.equal(bits(v), bits(torch.from_numpy(
        np.repeat(fact["v"][keep], eff)).to(dev))), "(b): column v"
    got_valid = w.valid[:n]
    assert torch.equal(got_valid, torch.from_numpy(valid).to(dev)), \
        "(b): NULLs of w"
    assert torch.equal(torch.where(got_valid, w.values[:n], 0),
                       torch.from_numpy(want_w.astype(np.int32)).to(dev)), \
        "(b): column w"
    return n, int((~hit).sum())


def check_left_outer_unique(torch, out, fact, half):
    """Run (c): every fact row, in order; g is NULL where fk is past the
    half dim.  Returns the NULL count."""
    kh = half["pk"].shape[0]
    assert int(out.num_rows) == FACT_ROWS, "(c): row count"
    hit = fact["fk"] < kh
    want_g = np.where(hit, half["g"][np.minimum(fact["fk"], kh - 1)], 0)
    v = out.columns["v"].values[:FACT_ROWS]
    dev = v.device
    assert torch.equal(bits(v), bits(torch.from_numpy(fact["v"]).to(dev))), \
        "(c): column v"
    g = out.columns["g"]
    got_valid = g.valid[:FACT_ROWS]
    assert torch.equal(got_valid, torch.from_numpy(hit).to(dev)), \
        "(c): NULLs of g"
    assert torch.equal(torch.where(got_valid, g.values[:FACT_ROWS], 0),
                       torch.from_numpy(want_g.astype(np.int32)).to(dev)), \
        "(c): column g"
    return int((~hit).sum())


def dup_key_dim():
    """Run (f)'s dim from default_rng(9): DIM_ROWS rows whose pk breaks its
    UNIQUE promise (a permutation of [0, DIM_ROWS) halved, so each of
    DIM_ROWS / 2 keys sits on two random rows) and a nullable g (10%
    NULL)."""
    rng = np.random.default_rng(9)
    return {"pk": (rng.permutation(DIM_ROWS) // 2).astype(np.int32),
            "g": rng.integers(0, GROUPS, DIM_ROWS).astype(np.int32),
            "g_valid": rng.random(DIM_ROWS) >= 0.1}


def dup_key_plan(T, fact_t, dup_t):
    """Run (f): LEFT_OUTER UNIQUE join of the fact against the dim with
    duplicate keys: the fat-LUT probe (pk is no row position)."""
    return T.HashJoin(T.JoinType.LEFT_OUTER, ["fk"], ["pk"],
                      T.ScanTable(fact_t), T.ScanTable(dup_t),
                      T.KeyUniqueness.UNIQUE,
                      lhs_projector=T.Projector.named("v"),
                      rhs_projector=T.Projector.named("g"))


def dup_key_want(torch, fact, dup, dev):
    """Run (f)'s g column in numpy, last wins: each fact row takes the value
    and validity of the LAST dim row holding its fk; NULL where none does.
    Returns (values with 0 under NULL, validity) on ``dev``."""
    keys = DIM_ROWS // 2
    win = np.full(keys, -1, dtype=np.int64)
    np.maximum.at(win, dup["pk"], np.arange(DIM_ROWS))
    fk = fact["fk"]
    hit = fk < keys
    row = win[np.minimum(fk, keys - 1)]
    valid = hit & dup["g_valid"][row]
    values = np.where(valid, dup["g"][row], 0).astype(np.int32)
    return (torch.from_numpy(values).to(dev), torch.from_numpy(valid).to(dev))


def check_dup_key_join(torch, out, want):
    """Run (f): every fact row in order, g from the last dim row of its key
    (value and validity), NULL past the keys.  Returns the NULL count."""
    assert int(out.num_rows) == FACT_ROWS, "(f): row count"
    g = out.columns["g"]
    got_valid = g.valid[:FACT_ROWS]
    assert torch.equal(got_valid, want[1]), "(f): NULLs of g"
    assert torch.equal(torch.where(got_valid, g.values[:FACT_ROWS], 0),
                       want[0]), "(f): column g"
    return int((~want[1]).sum())


def groupby_hi_tables(T, fact, dev):
    """Path (g)'s fact: the headline's fk (uniform over 1M keys) and v, and
    a DOUBLE d = rng.random(n) * 2e3 - 1e3 from default_rng(11), as
    bench_ops.py:119-126 makes it.  Returns (table, d)."""
    d = np.random.default_rng(11).random(FACT_ROWS) * 2e3 - 1e3
    schema = T.TupleSchema.of(("fk", T.INT32, False), ("v", T.FLOAT, False),
                              ("d", T.DOUBLE, False))
    return T.Table.from_numpy(schema, dict(fact, d=d), device=dev), d


def groupby_hi_plan(T, t):
    """Path (g): bench_ops.py:136-140's "groupby 8M->1M keys" at the
    headline's 100M rows, with COUNT(*), a DOUBLE SUM and a MAX beside its
    SUM: the sort path (1M keys is past the dense domain), insertion
    order."""
    A = T.Aggregation
    return T.GroupAggregate(
        ["fk"], [T.AggSpec(A.SUM, "v", "sv"), T.AggSpec(A.COUNT, None, "c"),
                 T.AggSpec(A.SUM, "d", "sd"), T.AggSpec(A.MAX, "v", "mx")],
        T.ScanTable(t), T.GroupAggregateOptions(
            estimated_result_row_count=HI_KEYS))


def groupby_hi_want(fk, v, d):
    """Path (g) in numpy, in first-occurrence order: (keys, counts, f64
    sums of v, f64 sums of d, sums of |d|, max of v) from one stable
    argsort."""
    order = np.argsort(fk, kind="stable")
    fs = fk[order]
    starts = np.flatnonzero(np.r_[True, fs[1:] != fs[:-1]])
    ins = np.argsort(order[starts], kind="stable")
    ds = d[order]
    return (fs[starts][ins],
            np.diff(np.r_[starts, fk.shape[0]])[ins],
            np.add.reduceat(v[order].astype(np.float64), starts)[ins],
            np.add.reduceat(ds, starts)[ins],
            np.add.reduceat(np.abs(ds), starts)[ins],
            np.maximum.reduceat(v[order], starts)[ins])


def check_groupby_hi(torch, out, want):
    """Path (g): keys in first-occurrence order and counts exact, sv within
    rtol 1e-4 of the f64 sum, sd within 1e-12 of the group's sum of |d|,
    mx bit for bit, no NULL.  Returns the group count."""
    keys, counts, sv, sd, sabs, mx = want
    n = keys.shape[0]
    assert int(out.num_rows) == n, "(g): group count"
    got = {c: out.columns[c].values[:n].cpu().numpy()
           for c in ("fk", "c", "sv", "sd", "mx")}
    for c in ("sv", "sd", "mx"):
        assert bool(out.columns[c].valid[:n].all()), f"(g): NULL in {c}"
    assert np.array_equal(got["fk"], keys), "(g): keys or their order"
    assert np.array_equal(got["c"], counts), "(g): counts"
    np.testing.assert_allclose(got["sv"], sv, rtol=SUM_RTOL)
    assert np.all(np.abs(got["sd"] - sd) <= DOUBLE_RTOL * sabs), "(g): sd"
    assert np.array_equal(got["mx"].view(np.int32), mx.view(np.int32)), \
        "(g): mx"
    return n


def same_bits(torch, a, b):
    """Whether two tables hold the same bits in every live value and
    validity."""
    n = int(a.num_rows)
    if n != int(b.num_rows):
        return False
    for name in a.schema.names():
        ca, cb = a.columns[name], b.columns[name]
        if not torch.equal(bits(ca.values[:n]), bits(cb.values[:n])):
            return False
        if (ca.valid is None) != (cb.valid is None) or (
                ca.valid is not None
                and not torch.equal(ca.valid[:n], cb.valid[:n])):
            return False
    return True


def groupby_few_table(T, fact, d, dev):
    """Path (j)'s fact: k INT64 = (fk mod 64) * 10^12 + 3, 64 keys whose
    values lie far above any row number, the headline's v and (g)'s DOUBLE
    d.  Returns (table, fk mod 64)."""
    g = (fact["fk"] % FEW_GROUPS).astype(np.int64)
    schema = T.TupleSchema.of(("k", T.INT64, False), ("v", T.FLOAT, False),
                              ("d", T.DOUBLE, False))
    return T.Table.from_numpy(schema, {"k": g * FEW_KEY_STEP + 3,
                                       "v": fact["v"], "d": d},
                              device=dev), g


def groupby_few_plan(T, t):
    """Path (j): TPC-H Q1's shape, a DOUBLE SUM (with an f32 SUM and a
    COUNT(*)) into a few groups, under a fused Filter(v > 0.5) and by an
    INT64 key of huge values: the sort path (a DOUBLE input is past the
    dense kernel), which sorts only the kept rows, whose ids the
    compaction kernel packs, and whose runs are 780k rows each."""
    A = T.Aggregation
    return T.GroupAggregate(
        ["k"], [T.AggSpec(A.SUM, "d", "sd"), T.AggSpec(A.SUM, "v", "sv"),
                T.AggSpec(A.COUNT, None, "c")],
        T.Filter(T.col("v") > T.Const(0.5, T.FLOAT), T.ScanTable(t)),
        T.GroupAggregateOptions(estimated_result_row_count=FEW_GROUPS))


def check_groupby_few(out, g, v, d):
    """Path (j): the 64 keys in first-occurrence order among the kept rows,
    counts exact, sd within 1e-12 of its group's sum of |d|, sv within
    rtol 1e-4 of float64.  Returns the group count."""
    keep = v > 0.5
    gk = g[keep]
    present, first = np.unique(gk[:100_000], return_index=True)
    assert present.shape[0] == FEW_GROUPS  # every group occurs in it
    order = present[np.argsort(first)]
    counts = np.bincount(gk, minlength=FEW_GROUPS)
    sd = np.bincount(gk, weights=d[keep], minlength=FEW_GROUPS)
    sabs = np.bincount(gk, weights=np.abs(d[keep]), minlength=FEW_GROUPS)
    sv = np.bincount(gk, weights=v[keep].astype(np.float64),
                     minlength=FEW_GROUPS)
    rows = out.to_pylist()
    assert [r[0] for r in rows] == [int(x) * FEW_KEY_STEP + 3
                                    for x in order], "(j): keys or order"
    assert [r[3] for r in rows] == [int(counts[x]) for x in order], \
        "(j): counts"
    got_sd = np.array([r[1] for r in rows])
    assert np.all(np.abs(got_sd - sd[order]) <= DOUBLE_RTOL * sabs[order]), \
        "(j): sd"
    np.testing.assert_allclose([r[2] for r in rows], sv[order],
                               rtol=SUM_RTOL)
    return len(rows)


def groupby_str_table(T, fact, dev):
    """Path (h)'s fact: k, a STRING column of the 50 words (int32 codes
    uniform over them, from default_rng(12), with their sorted Dictionary),
    and the headline's v.  Returns (table, codes)."""
    codes = np.random.default_rng(12).integers(
        0, len(WORDS), FACT_ROWS).astype(np.int32)
    schema = T.TupleSchema.of(("k", T.STRING, False), ("v", T.FLOAT, False))
    return T.Table.from_numpy(schema, {"k": codes, "v": fact["v"]}, None,
                              {"k": T.Dictionary(tuple(WORDS))},
                              device=dev), codes


def groupby_str_plan(T, t):
    """Path (h): bench_ops.py:234-238's "groupby_str 8M->50" at 100M rows,
    with a COUNT(*): dense by the dictionary's 50 codes."""
    A = T.Aggregation
    return T.GroupAggregate(
        ["k"], [T.AggSpec(A.SUM, "v", "sv"), T.AggSpec(A.COUNT, None, "c")],
        T.ScanTable(t), T.GroupAggregateOptions(estimated_result_row_count=64))


def check_groupby_str(out, codes, v):
    """Path (h): the 50 words in first-occurrence order, counts exact, sums
    within rtol 1e-4 of float64."""
    prefix = codes[:100_000]  # every word occurs in it (asserted)
    present, first = np.unique(prefix, return_index=True)
    assert present.shape[0] == len(WORDS)
    order = present[np.argsort(first)]
    counts = np.bincount(codes, minlength=len(WORDS))
    sums = np.bincount(codes, weights=v.astype(np.float64),
                       minlength=len(WORDS))
    rows = out.to_pylist()
    assert [r[0] for r in rows] == [WORDS[c] for c in order], \
        "(h): words or their order"
    assert [r[2] for r in rows] == [int(counts[c]) for c in order], \
        "(h): counts"
    np.testing.assert_allclose([r[1] for r in rows], sums[order],
                               rtol=SUM_RTOL)
    return len(rows)


# --- joins (k)-(n): the merge probe, sparse 64-bit and STRING keys, and the
# outer joins ---------------------------------------------------------------

STR_PRESENT = 750_000          # path (m): probe values the build side holds
STR_ABSENT = 250_000           # ... and build values the probe never holds


def merge_probe_plan(T, fact_t, dim_t):
    """Path (k): bench_ops.py:153-160's "join 8M x 1M (merge probe)" over
    the headline tables: INNER UNIQUE fk = pk without dense lookups."""
    return T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"], T.ScanTable(fact_t),
                      T.ScanTable(dim_t), T.KeyUniqueness.UNIQUE,
                      lhs_projector=T.Projector.named("v"),
                      rhs_projector=T.Projector.named("g"),
                      allow_dense_lookup=False)


def check_merge_probe(torch, out, fact, dim):
    """Path (k): every fact row matches (fk < DIM_ROWS), in fact order: v
    as it is, g of dim row fk, bit for bit."""
    assert int(out.num_rows) == FACT_ROWS, "(k): row count"
    dev = out.columns["v"].values.device
    for col, want in (("v", fact["v"]), ("g", dim["g"][fact["fk"]])):
        got = out.columns[col].values[:FACT_ROWS]
        assert torch.equal(bits(got), bits(torch.from_numpy(want).to(dev))), \
            f"(k): column {col}"


def sparse_key(k):
    """Path (l): INT64 key (k * 0x9E3779B97F4A7C15) mod 2^62, in uint64
    arithmetic; the multiplier is odd, so distinct keys stay distinct."""
    h = k.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return (h & np.uint64((1 << 62) - 1)).astype(np.int64)


def sparse64_tables(T, dfact, ddim, dev):
    """Path (l): the dup8 (a) tables with each key mapped by
    ``sparse_key``: their range passes every dense budget."""
    fs = T.TupleSchema.of(("fk", T.INT64, False), ("v", T.FLOAT, False))
    ds = T.TupleSchema.of(("pk", T.INT64, False), ("w", T.INT32, False))
    return (T.Table.from_numpy(fs, dict(dfact, fk=sparse_key(dfact["fk"])),
                               device=dev),
            T.Table.from_numpy(ds, dict(ddim, pk=sparse_key(ddim["pk"])),
                               device=dev))


def sparse64_plan(T, fact_t, dim_t):
    """Path (l): the dup8 NOT_UNIQUE INNER join over the sparse keys."""
    return T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"], T.ScanTable(fact_t),
                      T.ScanTable(dim_t), T.KeyUniqueness.NOT_UNIQUE,
                      lhs_projector=T.Projector.named("v"),
                      rhs_projector=T.Projector.named("w"),
                      out_capacity=DUP_OUT)


def join_str_tables(T, fact, dev):
    """Path (m): bench_ops.py:260-278's "join_str 8M x 1M" at 100M x 1M.
    The probe holds the headline fk as codes into a dictionary of the
    DIM_ROWS values key_0000000.., the build side 1M rows (a permutation,
    default_rng(5)): STR_PRESENT of those values and STR_ABSENT values
    key_1000000.. the probe never holds, in a dictionary of its own, with
    w in [0, 64).  Returns (fact table, dim table, w of each probe value's
    build row or -1)."""
    rng = np.random.default_rng(5)
    present = rng.permutation(DIM_ROWS)[:STR_PRESENT]
    vids = np.concatenate([present, DIM_ROWS + np.arange(STR_ABSENT)])
    vids = vids[rng.permutation(vids.shape[0])]
    w = rng.integers(0, 64, vids.shape[0]).astype(np.int32)
    svids = np.sort(vids)
    probe_dict = T.Dictionary(tuple(f"key_{i:07d}" for i in range(DIM_ROWS)))
    build_dict = T.Dictionary(tuple(f"key_{i:07d}" for i in svids))
    fact_t = T.Table.from_numpy(
        T.TupleSchema.of(("fk", T.STRING, False), ("v", T.FLOAT, False)),
        fact, None, {"fk": probe_dict}, device=dev)
    dim_t = T.Table.from_numpy(
        T.TupleSchema.of(("pk", T.STRING, False), ("w", T.INT32, False)),
        {"pk": np.searchsorted(svids, vids).astype(np.int32), "w": w}, None,
        {"pk": build_dict}, device=dev)
    w_of = np.full(DIM_ROWS, -1, dtype=np.int64)
    inside = vids < DIM_ROWS
    w_of[vids[inside]] = w[inside]
    return fact_t, dim_t, w_of


def join_str_plan(T, fact_t, dim_t):
    """Path (m): INNER UNIQUE fk = pk over STRING keys, lhs v, rhs w."""
    return T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"], T.ScanTable(fact_t),
                      T.ScanTable(dim_t), T.KeyUniqueness.UNIQUE,
                      lhs_projector=T.Projector.named("v"),
                      rhs_projector=T.Projector.named("w"))


def check_join_str(torch, out, fact, w_of):
    """Path (m): the fact rows whose value the build side holds, in fact
    order, v as it is and w of that build row.  Returns the row count."""
    hit_w = w_of[fact["fk"]]
    keep = hit_w >= 0
    n = int(keep.sum())
    assert int(out.num_rows) == n, "(m): row count"
    dev = out.columns["v"].values.device
    for col, want in (("v", fact["v"][keep]),
                      ("w", hit_w[keep].astype(np.int32))):
        got = out.columns[col].values[:n]
        assert torch.equal(bits(got), bits(torch.from_numpy(want).to(dev))), \
            f"(m): column {col}"
    return n


def outer_rows(fk, pk):
    """Path (n)'s row counts: (RIGHT_OUTER, FULL_OUTER) of fact keys ``fk``
    against dim keys ``pk`` (pk = row // 8)."""
    per_key = np.bincount(fk, minlength=DUP_KEYS)[:DUP_KEYS]
    right = int(np.maximum(per_key[pk], 1).sum())
    hit = fk < DUP_KEYS
    full = int(np.where(hit, 8, 1).sum()) + int((per_key[pk] == 0).sum())
    return right, full


def outer_plan(T, fact_t, dim_t, join_type, out_cap):
    """Path (n): dup8 (b)'s tables (fk over twice the dim's keys), without
    the Filter, NOT_UNIQUE, every column projected."""
    return T.HashJoin(join_type, ["fk"], ["pk"], T.ScanTable(fact_t),
                      T.ScanTable(dim_t), T.KeyUniqueness.NOT_UNIQUE,
                      out_capacity=out_cap)


def check_right_outer(torch, out, fk, v, dim):
    """Path (n) RIGHT_OUTER: for each dim row in order, the fact rows of its
    key in fact order, or one row with NULL fk and v.  Returns (rows, rows
    without a fact row)."""
    pk = dim["pk"]
    order = np.argsort(fk, kind="stable")
    per_key = np.bincount(fk, minlength=DUP_KEYS)[:DUP_KEYS]
    starts = np.concatenate([[0], np.cumsum(np.bincount(fk))])[:DUP_KEYS]
    cnt = per_key[pk]
    eff = np.maximum(cnt, 1)
    n = int(eff.sum())
    assert int(out.num_rows) == n, "(n) RIGHT_OUTER: row count"
    first = np.repeat(np.cumsum(eff) - eff, eff)
    j = np.arange(n) - first
    hit = np.repeat(cnt > 0, eff)
    src = order[np.where(hit, np.repeat(starts[pk], eff) + j, 0)]
    dev = out.columns["v"].values.device
    want = {"fk": (np.where(hit, fk[src], 0).astype(np.int32), hit),
            "v": (np.where(hit, v[src], 0).astype(np.float32), hit),
            "pk": (np.repeat(pk, eff), None),
            "w": (np.repeat(dim["w"], eff), None)}
    for col, (vals, valid) in want.items():
        c = out.columns[col]
        got = c.values[:n]
        if valid is not None:
            ok = torch.from_numpy(valid).to(dev)
            assert torch.equal(c.valid[:n], ok), f"(n) RIGHT_OUTER: NULLs {col}"
            got = torch.where(ok, got, torch.zeros_like(got))
        assert torch.equal(bits(got), bits(torch.from_numpy(vals).to(dev))), \
            f"(n) RIGHT_OUTER: column {col}"
    return n, int((cnt == 0).sum())


def row_words(torch, cols, n):
    """Path (n) FULL_OUTER's rows as two int64 words each, sorted: (fk + 1)
    << 32 | bits of v and (pk + 1) << 32 | w, 0 for a NULL column pair;
    sorted by the first word, then the second (stable passes)."""
    def word(key, val):
        kv, kok = key
        vv, vok = val
        w = ((kv.long() + 1) << 32) | (bits(vv).long() & 0xFFFFFFFF)
        if kok is not None:
            w = torch.where(kok, w, 0)
        return w
    a = word(cols["fk"], cols["v"])[:n]
    b = word(cols["pk"], cols["w"])[:n]
    o = torch.sort(b, stable=True)[1]
    o = o[torch.sort(a[o], stable=True)[1]]
    return a[o], b[o]


def check_full_outer(torch, out, fk, v, dim):
    """Path (n) FULL_OUTER as a multiset of rows against numpy: each fact
    row with its key's 8 dim rows, or with NULL pk and w past the dim's
    keys, then each dim row whose key no fact row holds, with NULL fk and
    v.  Returns (rows, NULL-padded dim rows)."""
    dev = out.columns["v"].values.device
    hit = fk < DUP_KEYS
    eff = np.where(hit, 8, 1)
    rows_l = int(eff.sum())
    first = np.repeat(np.cumsum(eff) - eff, eff)
    j = np.arange(rows_l) - first
    lhit = np.repeat(hit, eff)
    drow = np.where(lhit, np.repeat(8 * fk.astype(np.int64), eff) + j, 0)
    anti = np.nonzero(np.bincount(fk, minlength=DUP_KEYS)[:DUP_KEYS]
                      [dim["pk"]] == 0)[0]
    n = rows_l + anti.shape[0]
    assert int(out.num_rows) == n, "(n) FULL_OUTER: row count"

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    ones_l = np.ones(rows_l, dtype=bool)
    want = {
        "fk": (t(np.concatenate([np.repeat(fk, eff),
                                 np.zeros(anti.shape[0], np.int32)])),
               t(np.concatenate([ones_l, np.zeros(anti.shape[0], bool)]))),
        "v": (t(np.concatenate([np.repeat(v, eff),
                                np.zeros(anti.shape[0], np.float32)])),
              None),
        "pk": (t(np.concatenate([np.where(lhit, dim["pk"][drow], 0),
                                 dim["pk"][anti]]).astype(np.int32)),
               t(np.concatenate([lhit, np.ones(anti.shape[0], bool)]))),
        "w": (t(np.concatenate([np.where(lhit, dim["w"][drow], 0),
                                dim["w"][anti]]).astype(np.int32)), None)}
    got = {}
    for col in ("fk", "v", "pk", "w"):
        c = out.columns[col]
        got[col] = (c.values[:n], None if c.valid is None else c.valid[:n])
    # a row's lhs columns are NULL together, and so are its rhs columns
    assert torch.equal(got["v"][1], got["fk"][1]), "(n) FULL_OUTER: v NULLs"
    assert torch.equal(got["w"][1], got["pk"][1]), "(n) FULL_OUTER: w NULLs"
    g_words, w_words = row_words(torch, got, n), row_words(torch, want, n)
    assert (torch.equal(g_words[0], w_words[0])
            and torch.equal(g_words[1], w_words[1])), \
        "(n) FULL_OUTER: the rows differ as a multiset"
    return n, anti.shape[0]


# --- paths (o)-(t) and CONCAT: the scalar, distinct, cluster, clamped and
# quota aggregates, Limit and friends, the row-id joins -------------------

Q6_LO, Q6_HI = 8766, 9131     # 1994-01-01 and 1995-01-01 as DATE days
CLUSTER_ROWS = 1000           # path (q2): rows a raw-order cluster
CLAMP_KEYS = 1000             # path (r): max_unique_keys_in_result
QUOTA_ROWS = 250_000          # path (r): result rows the quota holds
CONCAT_ROWS = 1_000_000       # the CONCAT path's slice of (h)'s table
LIMIT_OFFSET = 25_000_000     # path (s2): Limit(25M, 50M) of the fact
LIMIT_ROWS = 50_000_000


def host_cols(out, names=None):
    """The live rows of ``out``'s columns as numpy arrays, read straight
    from the tensors (no Python object a value); each must be all valid."""
    n = int(out.num_rows)
    cols = {}
    for name in names or out.schema.names():
        c = out.columns[name]
        if c.valid is not None:
            assert bool(c.valid[:n].all()), f"NULL in {name}"
        cols[name] = c.values[:n].cpu().numpy()
    return cols


def lineitem_data(n=FACT_ROWS, seed=42):
    """Path (o)'s lineitem-shaped columns from default_rng(seed), with the
    TPC-H spec's distributions (section 4.2.3): l_shipdate uniform over
    1992-01-02 .. 1998-12-01, l_discount 0.00-0.10 in steps of 0.01,
    l_quantity 1-50, l_extendedprice = l_quantity x a retail price in
    [900, 2100), to the cent."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 51, n).astype(np.int32)
    return {"l_shipdate": rng.integers(8036, 10562, n).astype(np.int32),
            "l_discount": rng.integers(0, 11, n) / 100,
            "l_quantity": q,
            "l_extendedprice": np.round(
                q * (900 + rng.random(n) * 1200), 2)}


def lineitem_table(T, li, dev):
    schema = T.TupleSchema.of(
        ("l_shipdate", T.DATE, False), ("l_discount", T.DOUBLE, False),
        ("l_quantity", T.INT32, False), ("l_extendedprice", T.DOUBLE, False))
    return T.Table.from_numpy(schema, li, device=dev)


def q6_plan(T, t, hi=Q6_HI):
    """Path (o): TPC-H Q6's plan, ScalarAggregate(SUM(rev) DOUBLE,
    COUNT(*)) over Compute(rev = l_extendedprice * l_discount) over a
    Filter on a year of l_shipdate, l_discount BETWEEN 0.05 AND 0.07 and
    l_quantity < 24 (about 1.8% of the rows); ``hi`` = Q6_LO keeps
    nothing."""
    c, C = T.col, T.Const
    pred = ((c("l_shipdate") >= C(Q6_LO, T.DATE))
            & (c("l_shipdate") < C(hi, T.DATE))
            & (c("l_discount") >= C(0.05, T.DOUBLE))
            & (c("l_discount") <= C(0.07, T.DOUBLE))
            & (c("l_quantity") < C(24, T.INT32)))
    A = T.Aggregation
    return T.ScalarAggregate(
        [T.AggSpec(A.SUM, "rev", "revenue"), T.AggSpec(A.COUNT, None, "n")],
        T.Compute([(c("l_extendedprice") * c("l_discount")).as_("rev")],
                  T.Filter(pred, T.ScanTable(t))))


def check_q6(out, li):
    """Path (o): the count exact, the sum within 1e-12 of the kept rows'
    sum of |rev|.  Returns the kept row count."""
    keep = ((li["l_shipdate"] >= Q6_LO) & (li["l_shipdate"] < Q6_HI)
            & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
            & (li["l_quantity"] < 24))
    rev = li["l_extendedprice"][keep] * li["l_discount"][keep]
    ((revenue, n),) = out.to_pylist()
    assert n == int(keep.sum()), "(o): Q6 count"
    assert abs(revenue - float(np.sum(rev))) <= DOUBLE_RTOL * float(
        np.sum(np.abs(rev))), "(o): Q6 revenue"
    return n


def fact_g_table(T, fact, dim, dev, n=None):
    """The headline fact with its group g = dim.g[fk] beside fk and v (the
    join's result, made on the host), first ``n`` rows."""
    n = fact["fk"].shape[0] if n is None else n
    schema = T.TupleSchema.of(("g", T.INT32, False), ("fk", T.INT32, False),
                              ("v", T.FLOAT, False))
    data = {"g": dim["g"][fact["fk"][:n]], "fk": fact["fk"][:n],
            "v": fact["v"][:n]}
    return T.Table.from_numpy(schema, data, device=dev), data


def scalar_distinct_plan(T, t):
    """Path (o)'s second scalar: COUNT(DISTINCT fk), SUM(DISTINCT g), MIN,
    MAX, FIRST and LAST of v, COUNT(*) over the whole fact."""
    A = T.Aggregation
    return T.ScalarAggregate(
        [T.AggSpec(A.COUNT, "fk", "dfk", distinct=True),
         T.AggSpec(A.SUM, "g", "dg", distinct=True),
         T.AggSpec(A.MIN, "v", "mn"), T.AggSpec(A.MAX, "v", "mx"),
         T.AggSpec(A.FIRST, "v", "fv"), T.AggSpec(A.LAST, "v", "lv"),
         T.AggSpec(A.COUNT, None, "n")], T.ScanTable(t))


def check_scalar_distinct(out, fg):
    """Path (o): every value exact."""
    fk, g, v = fg["fk"], fg["g"], fg["v"]
    want = (int(np.count_nonzero(np.bincount(fk))),
            int(np.flatnonzero(np.bincount(g)).sum()), float(v.min()),
            float(v.max()),
            float(v[0]), float(v[-1]), fk.shape[0])
    assert out.to_pylist() == [want], ("(o): scalar DISTINCT", want)


def distinct_groupby_plan(T, t):
    """Path (p): TPC-H Q16's aggregate shape, GroupAggregate(g;
    COUNT(DISTINCT fk), COUNT(*), SUM v) into 64 groups in insertion order:
    the sort path, with a value-ordered pass by (g, fk)."""
    A = T.Aggregation
    return T.GroupAggregate(
        ["g"], [T.AggSpec(A.COUNT, "fk", "dfk", distinct=True),
                T.AggSpec(A.COUNT, None, "c"), T.AggSpec(A.SUM, "v", "sv")],
        T.ScanTable(t), T.GroupAggregateOptions(
            estimated_result_row_count=GROUPS))


def check_distinct_groupby(out, fg):
    """Path (p): groups in first-occurrence order, the distinct counts
    from a bitmap over g * 2^20 + fk (np.unique's answer), counts exact,
    sums within rtol 1e-4 of float64."""
    g, fk, v = fg["g"], fg["fk"], fg["v"]
    present, first = np.unique(g[:100_000], return_index=True)
    assert present.shape[0] == GROUPS
    order = present[np.argsort(first)]
    seen = np.zeros((GROUPS, 1 << 20), dtype=bool)
    seen[g, fk] = True
    distinct = seen.sum(axis=1)
    counts = np.bincount(g, minlength=GROUPS)
    sums = np.bincount(g, weights=v.astype(np.float64), minlength=GROUPS)
    rows = out.to_pylist()
    assert [r[0] for r in rows] == order.tolist(), "(p): groups or order"
    assert [r[1] for r in rows] == distinct[order].tolist(), \
        "(p): COUNT(DISTINCT fk)"
    assert [r[2] for r in rows] == counts[order].tolist(), "(p): counts"
    np.testing.assert_allclose([r[3] for r in rows], sums[order],
                               rtol=SUM_RTOL)
    return len(rows)


def cluster_specs(T):
    A = T.Aggregation
    return [T.AggSpec(A.SUM, "v", "sv"), T.AggSpec(A.COUNT, None, "c"),
            T.AggSpec(A.MIN, "v", "mn"), T.AggSpec(A.MAX, "v", "mx"),
            T.AggSpec(A.FIRST, "v", "fv"), T.AggSpec(A.LAST, "v", "lv")]


def clusters_merge_plan(T, tables):
    """Path (q1): AggregateClusters(g; SUM, COUNT(*), MIN, MAX, FIRST, LAST
    of v) over merge (d)'s plan, 2 x 50M rows sorted by (g ASC, v DESC):
    64 clusters."""
    return T.AggregateClusters(["g"], cluster_specs(T), merge_plan(T, tables))


def check_clusters_merge(out, runs):
    """Path (q1) against numpy over the runs: one cluster a g in order, its
    count, f64 sum (rtol 1e-4 of float64), MIN, MAX; FIRST is the largest
    v and LAST the smallest (v DESC within g); values compared with ==, so
    -0.0 equals +0.0 as the order ties them."""
    counts = np.zeros(GROUPS, np.int64)
    sums = np.zeros(GROUPS)
    mn = np.full(GROUPS, np.inf, np.float32)
    mx = np.full(GROUPS, -np.inf, np.float32)
    for g, v, _ in runs:  # each run is sorted by g, every g in it
        g, v = g.cpu().numpy(), v.cpu().numpy()
        c = np.bincount(g, minlength=GROUPS)
        starts = np.r_[0, np.cumsum(c)[:-1]]
        counts += c
        sums += np.add.reduceat(v.astype(np.float64), starts)
        mn = np.minimum(mn, np.minimum.reduceat(v, starts))
        mx = np.maximum(mx, np.maximum.reduceat(v, starts))
    rows = out.to_pylist()
    assert [r[0] for r in rows] == list(range(GROUPS)), "(q1): clusters"
    assert [r[2] for r in rows] == counts.tolist(), "(q1): counts"
    np.testing.assert_allclose([r[1] for r in rows], sums, rtol=SUM_RTOL)
    for name, i, want in (("MIN", 3, mn), ("MAX", 4, mx), ("FIRST", 5, mx),
                          ("LAST", 6, mn)):
        assert np.array_equal(np.array([r[i] for r in rows], np.float32),
                              want), f"(q1): {name}"
    return len(rows)


def clusters_raw_table(T, v, dev):
    """Path (q2)'s table: k = (row // 1000) % 64 in raw order, so each key
    comes back every 64 clusters, and the headline's v."""
    n = v.shape[0]
    k = ((np.arange(n) // CLUSTER_ROWS) % GROUPS).astype(np.int32)
    schema = T.TupleSchema.of(("k", T.INT32, False), ("v", T.FLOAT, False))
    return T.Table.from_numpy(schema, {"k": k, "v": v}, device=dev)


def clusters_raw_plan(T, t):
    """Path (q2): AggregateClusters over 100M raw-order rows, 100k clusters
    of 1000 rows; equal keys that are not adjacent are clusters of their
    own."""
    return T.AggregateClusters(["k"], cluster_specs(T), T.ScanTable(t))


def check_clusters_raw(out, v):
    """Path (q2) against numpy: one row a 1000-row block, in order."""
    b = v.reshape(-1, CLUSTER_ROWS)
    nb = b.shape[0]
    assert int(out.num_rows) == nb, "(q2): cluster count"
    cols = host_cols(out)
    assert np.array_equal(cols["k"], np.arange(nb) % GROUPS), "(q2): keys"
    assert np.all(cols["c"] == CLUSTER_ROWS), "(q2): counts"
    np.testing.assert_allclose(cols["sv"], b.astype(np.float64).sum(1),
                               rtol=SUM_RTOL)
    for name, want in (("mn", b.min(1)), ("mx", b.max(1)), ("fv", b[:, 0]),
                       ("lv", b[:, -1])):
        assert np.array_equal(cols[name].view(np.int32),
                              want.view(np.int32)), f"(q2): {name}"
    return nb


def clamp_plan(T, t):
    """Path (r1): (g)'s plan with max_unique_keys_in_result = 1000."""
    plan = groupby_hi_plan(T, t)
    plan.options = T.GroupAggregateOptions(
        estimated_result_row_count=HI_KEYS,
        max_unique_keys_in_result=CLAMP_KEYS)
    return plan


def check_clamp(out, want):
    """Path (r1): the first 999 groups of (g)'s result exactly, then the
    1000th holding every later group: counts added, sums within their
    tolerances, MAX the largest."""
    keys, counts, sv, sd, sabs, mx = want
    K = CLAMP_KEYS
    assert int(out.num_rows) == K, "(r1): row count"
    cols = host_cols(out)
    assert np.array_equal(cols["fk"], keys[:K]), "(r1): keys"
    assert np.array_equal(cols["c"][:K - 1], counts[:K - 1]), "(r1): counts"
    assert cols["c"][K - 1] == counts[K - 1:].sum(), "(r1): folded count"
    got_sv, got_sd, got_mx = cols["sv"], cols["sd"], cols["mx"]
    np.testing.assert_allclose(got_sv[:K - 1], sv[:K - 1], rtol=SUM_RTOL)
    np.testing.assert_allclose(got_sv[K - 1], sv[K - 1:].sum(), rtol=SUM_RTOL)
    assert np.all(np.abs(got_sd[:K - 1] - sd[:K - 1])
                  <= DOUBLE_RTOL * sabs[:K - 1]), "(r1): sd"
    assert abs(got_sd[K - 1] - sd[K - 1:].sum()) <= 1e-9 * sabs[K - 1:].sum(), \
        "(r1): folded sd"
    assert np.array_equal(got_mx[:K - 1], mx[:K - 1]), "(r1): mx"
    assert got_mx[K - 1] == mx[K - 1:].max(), "(r1): folded mx"


def quota_plan(T, t, cls, enforce=False):
    """Path (r2): (g)'s plan under a memory_quota worth 250k result rows
    (fk 4 bytes, sv and mx 4 + 1, c 8, sd 8 + 1: 31 bytes a row)."""
    plan = groupby_hi_plan(T, t)
    return getattr(T, cls)(plan.group_by, plan.spec, plan.child,
                           T.GroupAggregateOptions(
                               memory_quota=QUOTA_ROWS * 31,
                               enforce_quota=enforce))


def check_best_effort(out, fk, want):
    """Path (r2): the QUOTA_ROWS smallest keys (the first in sort order)
    appear once each, every later row is a group of its own, and
    re-aggregating the rows by key gives (g)'s result: counts exact, sums
    within their tolerances, MAX exact."""
    keys, counts, sv, sd, sabs, mx = want
    cols = host_cols(out)
    k = cols["fk"]
    cut = np.sort(keys)[QUOTA_ROWS]  # the first key past the budget
    n_after = int((fk >= cut).sum())
    assert k.shape[0] == QUOTA_ROWS + n_after, "(r2): row count"
    head = k[k < cut]
    assert head.shape[0] == QUOTA_ROWS and np.unique(head).shape[0] == \
        QUOTA_ROWS, "(r2): the first keys once each"
    assert np.all(cols["c"][k >= cut] == 1), "(r2): later rows alone"
    K = DIM_ROWS
    want_c = np.bincount(keys, weights=counts, minlength=K)
    assert np.array_equal(np.bincount(k, weights=cols["c"], minlength=K),
                          want_c), "(r2): counts"
    got_sv = np.bincount(k, weights=cols["sv"], minlength=K)
    np.testing.assert_allclose(got_sv[keys], sv, rtol=SUM_RTOL)
    got_sd = np.bincount(k, weights=cols["sd"], minlength=K)
    assert np.all(np.abs(got_sd[keys] - sd) <= 1e-9 * sabs), "(r2): sd"
    import torch

    got_mx = torch.full((K,), -np.inf).scatter_reduce_(
        0, torch.from_numpy(k).long(), torch.from_numpy(cols["mx"]),
        "amax").numpy()
    assert np.array_equal(got_mx[keys], mx), "(r2): mx"
    return k.shape[0]


def topn_plan(T, t):
    """Path (s1): Limit(0, 10) over Sort(sv DESC) of (g)'s result, a top-N
    as TPC-H Q3, Q10 and Q18 end."""
    return T.Limit(0, 10, T.Sort([T.SortKey("sv", ascending=False)],
                                 groupby_hi_plan(T, t)))


def check_topn(out, want):
    keys, _, sv, *_ = want
    rows = out.to_pylist()
    by_key = dict(zip(keys.tolist(), sv.tolist()))
    assert len(rows) == 10, "(s1): rows"
    got = [r[1] for r in rows]
    assert got == sorted(got, reverse=True), "(s1): order"
    for r in rows:
        assert abs(r[1] - by_key[r[0]]) <= SUM_RTOL * abs(by_key[r[0]]), \
            "(s1): sums"
    assert min(got) >= np.sort(sv)[-11] * (1 - SUM_RTOL), "(s1): the top 10"


def check_slices(torch, out, t, offset, n):
    """The window (offset, n) of ``t``, every column bit for bit."""
    assert int(out.num_rows) == n, "window row count"
    for name in t.schema.names():
        assert torch.equal(bits(out.columns[name].values[:n]),
                           bits(t.columns[name].values[offset:offset + n])), \
            f"window column {name}"


def coalesce_plan(T, t):
    """Path (s3): Coalesce of the fact with a Compute over it."""
    return T.Coalesce(T.ScanTable(t), T.Compute(
        [(T.col("v") * T.Const(2.0, T.FLOAT)).as_("v2")], T.ScanTable(t)))


def check_coalesce(torch, out, fact_t):
    """Path (s3): the fact's columns as they are, and v2 = 2 v bit for
    bit."""
    v = fact_t.columns["v"].values
    assert int(out.num_rows) == fact_t.capacity, "(s3): rows"
    assert out.columns["v"].values is v, "(s3): v moved"
    assert torch.equal(bits(out.columns["v2"].values), bits(v * 2)), \
        "(s3): v2"


def generate_plan(T, n, dev):
    """Path (s4): Generate(n) + Compute(Sequence)."""
    return T.Compute([T.Sequence().as_("q")], T.Generate(n, device=dev))


def rowid_plan(T, fact_t, dim_t):
    """Path (t1): RowidMergeJoin of the fact's fk against the dim's row ids:
    one gather of the dim's lanes."""
    return T.RowidMergeJoin("fk", T.ScanTable(fact_t), T.ScanTable(dim_t))


def check_rowid(torch, out, fact, dim, dev):
    """Path (t1): every fact row with its dim row, against numpy."""
    assert int(out.num_rows) == fact["fk"].shape[0], "(t1): rows"
    for name, want in (("fk", fact["fk"]), ("v", fact["v"]),
                       ("pk", dim["pk"][fact["fk"]]),
                       ("g", dim["g"][fact["fk"]])):
        assert torch.equal(bits(out.columns[name].values),
                           bits(torch.from_numpy(want).to(dev))), \
            f"(t1): {name}"


def foreign_tables(torch, T, fact, dev):
    """Path (t2): the fact sorted by fk (fk, v; a stable sort on the
    card), and an ascending key column holding every other dim key
    (500k)."""
    fk = torch.from_numpy(fact["fk"]).to(dev)
    fk, order = torch.sort(fk, stable=True)
    v = torch.from_numpy(fact["v"]).to(dev)[order]
    fs = T.TupleSchema.of(("fk", T.INT32, False), ("v", T.FLOAT, False))
    ks = T.TupleSchema.of(("key", T.INT32, False))
    sorted_fact = {"fk": fk.cpu().numpy(), "v": v.cpu().numpy()}
    del fk, order, v
    keys = np.arange(0, DIM_ROWS, 2, dtype=np.int32)
    return (T.Table.from_numpy(fs, sorted_fact, device=dev),
            T.Table.from_numpy(ks, {"key": keys}, device=dev), sorted_fact)


def foreign_plan(T, fact_t, key_t):
    """Path (t2): ForeignFilter(fk, key) of the sorted fact."""
    return T.ForeignFilter("fk", "key", T.ScanTable(fact_t),
                           T.ScanTable(key_t))


def check_foreign(torch, out, sorted_fact, dev):
    """Path (t2): the rows with an even fk, in order, fk rewritten to
    fk // 2 (the key's row id).  Returns the row count."""
    keep = sorted_fact["fk"] % 2 == 0
    n = int(keep.sum())
    assert int(out.num_rows) == n, "(t2): rows"
    want_fk = torch.from_numpy(sorted_fact["fk"][keep] // 2).to(dev)
    want_v = torch.from_numpy(sorted_fact["v"][keep]).to(dev)
    assert torch.equal(out.columns["fk"].values[:n], want_fk), "(t2): fk"
    assert torch.equal(bits(out.columns["v"].values[:n]), bits(want_v)), \
        "(t2): v"
    return n


def concat_table(T, fact, dim, codes, dev, n=CONCAT_ROWS):
    """The CONCAT path's table: the first ``n`` rows of (h)'s table, its
    words w (STRING codes) and v, with the headline's group g."""
    schema = T.TupleSchema.of(("g", T.INT32, False), ("w", T.STRING, False),
                              ("v", T.FLOAT, False))
    data = {"g": dim["g"][fact["fk"][:n]], "w": codes[:n],
            "v": fact["v"][:n]}
    return T.Table.from_numpy(schema, data, None,
                              {"w": T.Dictionary(tuple(WORDS))},
                              device=dev), data


def concat_plan(T, t):
    """The CONCAT path: GroupAggregate(g; CONCAT(w), CONCAT(DISTINCT w),
    SUM v)."""
    A = T.Aggregation
    return T.GroupAggregate(
        ["g"], [T.AggSpec(A.CONCAT, "w", "cw"),
                T.AggSpec(A.CONCAT, "w", "cdw", distinct=True),
                T.AggSpec(A.SUM, "v", "sv")], T.ScanTable(t),
        T.GroupAggregateOptions(estimated_result_row_count=GROUPS))


def check_concat(out, data):
    """The CONCAT path, byte for byte against a Python join in input order
    (DISTINCT: each word at its first place), groups in first-occurrence
    order.  Returns the group count."""
    parts, seen = {}, {}
    for g, w in zip(data["g"].tolist(), data["w"].tolist()):
        parts.setdefault(g, []).append(WORDS[w])
        seen.setdefault(g, {}).setdefault(WORDS[w], None)
    rows = out.to_pylist()
    assert [r[0] for r in rows] == list(parts), "(concat): groups or order"
    for r in rows:
        assert r[1] == ",".join(parts[r[0]]), "(concat): CONCAT(w)"
        assert r[2] == ",".join(seen[r[0]]), "(concat): CONCAT(DISTINCT w)"
    return len(rows)


# --- paths (u)-(z): the expression engine, its types and the host render ---

MATH_ROWS = FACT_ROWS          # path (u): bench_ops.py:240-258 at 100M rows
Q14_LO = 9374                  # path (v): 1995-09-01 as DATE days
TS_LO = 694_224_000_000_000    # path (x): 1992-01-01 00:00 UTC in us
TS_HI = 978_307_200_000_000    # ... 2001-01-01 00:00 UTC
LOCAL_ZONE = "America/New_York"  # the date_local golden's zone
FLUSH_EVERY = 1000             # path (y): one flush in ~1000 rows
RENDER_ROWS = 1_000_000        # path (z): the host render's rows
CHECK_THREADS = 6              # host threads for inputs and numpy checks
TRANSCENDENTAL_RTOL = 1e-12
# TPC-H spec 4.2.2.13: p_type = one word of each syllable, 150 types
TYPE_S1 = ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
TYPE_S2 = ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
TYPE_S3 = ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")
P_TYPES = tuple(sorted(f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                       for c in TYPE_S3))
# TPC-H spec 4.2.3: l_shipmode and o_orderpriority
SHIPMODES = tuple(sorted(("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL",
                          "FOB")))
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")


def close(got, want, rtol, what):
    """|got - want| <= rtol |want| everywhere (NaN where want is NaN)."""
    bad = ~(np.abs(got - want) <= rtol * np.abs(want))
    bad &= ~(np.isnan(got) & np.isnan(want))
    assert not bad.any(), f"{what}: {int(bad.sum())} rows off, first at " \
        f"{int(np.flatnonzero(bad)[0])}"


def math_data(n=MATH_ROWS, seed=42):
    """Path (u)'s columns: bench_ops.py:240-245's c0 INT32 in 0-999, c1
    INT64 in -50..50, c2 DOUBLE in [0, 1), from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return {"c0": rng.integers(0, 1000, n).astype(np.int32),
            "c1": rng.integers(-50, 51, n),
            "c2": rng.random(n)}


def math_table(T, data, dev):
    """Path (u)'s table of ``math_data``."""
    schema = T.TupleSchema.of(("c0", T.INT32, False), ("c1", T.INT64, False),
                              ("c2", T.DOUBLE, False))
    return T.Table.from_numpy(schema, data, device=dev)


def math_plans(T, t):
    """Path (u): bench_ops.py's "compute c0*(sin+exp)" (the reference's
    operation_example.cc:44-50), then the roundings, a signaling cast, a
    nulling log and Abs."""
    c, C = T.col, T.Const
    first = T.Compute(
        [(c("c0") * (T.Sin(c("c2")) + T.Exp(c("c1")))).as_("expr")],
        T.ScanTable(t))
    second = T.Compute(
        [T.RoundWithPrecision(c("c2") * C(1000), 2).as_("rp"),
         T.RoundToInt(c("c2") * C(7) - C(3.5)).as_("ri"),
         T.CastSignaling(T.INT32, c("c2") * C(1e6)).as_("ci"),
         T.LnNulling(c("c2") - C(0.5)).as_("ln"),
         T.Abs(c("c1")).as_("ab")], T.ScanTable(t))
    return first, second


def away(x):
    """C++ round(): halves away from zero."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def check_math_expr(out1, data):
    """Path (u)'s first Compute against numpy, within 1e-12."""
    c0, c1, c2 = data["c0"], data["c1"], data["c2"]
    expr = out1.columns["expr"].values.cpu().numpy()
    close(expr, c0 * (np.sin(c2) + np.exp(c1.astype(np.float64))),
          TRANSCENDENTAL_RTOL, "(u) c0 * (sin + exp)")


def check_math(out2, data):
    """Path (u)'s second Compute against numpy: LnNulling within 1e-12,
    the rest exact (RoundWithPrecision as the JAX package computes it: the
    rounded value times the scale's reciprocal)."""
    c1, c2 = data["c1"], data["c2"]
    cols = {n: out2.columns[n] for n in ("rp", "ri", "ci", "ln", "ab")}
    rp = cols["rp"].values.cpu().numpy()
    assert np.array_equal(rp, away(c2 * 1000.0 * 100.0) * (1.0 / 100.0)), \
        "(u) RoundWithPrecision"
    assert np.array_equal(cols["ri"].values.cpu().numpy(),
                          away(c2 * 7.0 - 3.5).astype(np.int64)), \
        "(u) RoundToInt"
    assert np.array_equal(cols["ci"].values.cpu().numpy(),
                          np.trunc(c2 * 1e6).astype(np.int32)), \
        "(u) CastSignaling"
    ok = cols["ln"].valid.cpu().numpy()
    assert np.array_equal(ok, c2 - 0.5 > 0), "(u) LnNulling NULLs"
    close(cols["ln"].values.cpu().numpy()[ok], np.log(c2[ok] - 0.5),
          TRANSCENDENTAL_RTOL, "(u) LnNulling")
    assert np.array_equal(cols["ab"].values.cpu().numpy(), np.abs(c1)), \
        "(u) Abs"
    return int((~ok).sum())


TEXT_WORDS = {"p_type": P_TYPES, "l_shipmode": SHIPMODES,
              "o_orderpriority": PRIORITIES}


def text_data(n=FACT_ROWS, seed=43):
    """Paths (v) and (w)'s STRING codes: p_type (TPC-H 4.2.2.13's 150
    types), l_shipmode (7 modes) and o_orderpriority (5 priorities), each
    uniform, from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, len(w), n).astype(np.int32)
            for k, w in TEXT_WORDS.items()}


def tpch_text_table(T, li_t, text, dev):
    """Paths (v) and (w): (o)'s lineitem columns (the same tensors) with
    the ``text_data`` columns."""
    attrs = list(li_t.schema) + [T.Attribute(k, T.STRING, False)
                                 for k in text]
    cols = dict(li_t.columns)
    dicts = {}
    for k, codes in text.items():
        cols[k] = T.Column(torch_from(codes, dev), None)
        dicts[k] = T.Dictionary(TEXT_WORDS[k])
    return T.Table(T.TupleSchema(attrs), cols, int(li_t.num_rows), dev, dicts)


def torch_from(a, dev):
    import torch

    return torch.from_numpy(a).to(dev)


def q14_plan(T, t):
    """Path (v): TPC-H Q14's promo revenue (spec 2.18, 2.4.14) over a month
    of l_shipdate."""
    c, C = T.col, T.Const
    start = T.ConstDate(Q14_LO)
    rev = c("l_extendedprice") * (C(1) - c("l_discount"))
    A = T.Aggregation
    return T.ScalarAggregate(
        [T.AggSpec(A.SUM, "promo", "promo_revenue"),
         T.AggSpec(A.SUM, "rev", "revenue")],
        T.Compute([T.If(T.RegexpPartialMatch(c("p_type"), "^PROMO"), rev,
                        C(0.0)).as_("promo"), rev.as_("rev")],
                  T.Filter((c("l_shipdate") >= start)
                           & (c("l_shipdate") < T.AddMonths(start, 1)),
                           T.ScanTable(t))))


def check_q14(out, li, text):
    """Path (v): both sums within 1e-12 of the kept rows' sum of |rev|.
    Returns the kept row count."""
    keep = (li["l_shipdate"] >= Q14_LO) & (li["l_shipdate"] < Q14_LO + 30)
    rev = li["l_extendedprice"][keep] * (1.0 - li["l_discount"][keep])
    promo = np.array([w.startswith("PROMO") for w in P_TYPES])
    is_promo = promo[text["p_type"][keep]]
    ((p, r),) = out.to_pylist()
    scale = float(np.sum(np.abs(rev)))
    assert abs(p - float(np.sum(np.where(is_promo, rev, 0.0)))) <= \
        DOUBLE_RTOL * scale, "(v) promo revenue"
    assert abs(r - float(np.sum(rev))) <= DOUBLE_RTOL * scale, "(v) revenue"
    return int(keep.sum())


def q12_plan(T, t):
    """Path (w): TPC-H Q12's shape (spec 2.4.12): by year and ship mode,
    the high-priority line count and the line count, of MAIL and SHIP
    lines."""
    c, C = T.col, T.Const
    A = T.Aggregation
    high = T.Case(c("o_orderpriority"), T.ConstInt64(0),
                  C("1-URGENT"), T.ConstInt64(1), C("2-HIGH"),
                  T.ConstInt64(1))
    return T.GroupAggregate(
        ["yr", "l_shipmode"],
        [T.AggSpec(A.SUM, "high", "high_lines", T.INT64),
         T.AggSpec(A.COUNT, None, "lines")],
        T.Compute([T.Year(c("l_shipdate")).as_("yr"), c("l_shipmode"),
                   high.as_("high")],
                  T.Filter(T.In(c("l_shipmode"), C("MAIL"), C("SHIP")),
                           T.ScanTable(t))))


def check_q12(out, li, text):
    """Path (w): every group's counts exact.  Returns the group count."""
    mode = text["l_shipmode"]
    keep = (mode == SHIPMODES.index("MAIL")) | (mode == SHIPMODES.index("SHIP"))
    i, lut = day_luts(li["l_shipdate"][keep].astype(np.int64))
    year = lut["y"][i]
    key = (year - 1990) * 8 + mode[keep]
    lines = np.bincount(key)
    high = np.bincount(key, weights=text["o_orderpriority"][keep] < 2)
    want = {(int(k) // 8 + 1990, SHIPMODES[int(k) % 8]):
            (int(high[k]), int(lines[k])) for k in np.flatnonzero(lines)}
    got = {(r[0], r[1]): (r[2], r[3]) for r in out.to_pylist()}
    assert got == want, "(w) Q12 groups"
    return len(got)


def date_data(n=FACT_ROWS, seed=44):
    """Path (x): n microsecond instants uniform over 1992-2000, from
    default_rng(seed)."""
    return np.random.default_rng(seed).integers(TS_LO, TS_HI, n)


def date_table(T, t, dev):
    """Path (x)'s table: ``date_data`` as a DATETIME column."""
    return T.Table.from_numpy(T.TupleSchema.of(("t", T.DATETIME, False)),
                              {"t": t}, device=dev)


def dates_plan(T, t):
    """Path (x), UTC: the fields, AddMonths(t, -1) and a month-granular
    DateFormat under a domain (one LUT gather)."""
    c = T.col("t")
    return T.Compute(
        [T.Year(c).as_("y"), T.Month(c).as_("mo"), T.Day(c).as_("d"),
         T.Hour(c).as_("h"), T.Weekday(c).as_("wd"),
         T.AddMonths(c, -1).as_("am"),
         T.DateFormat(c, "%Y-%m", domain=(TS_LO, TS_HI)).as_("ym")],
        T.ScanTable(t))


def local_plan(T, t):
    """Path (x), local: HourLocal and DayLocal under the bound zone."""
    c = T.col("t")
    return T.Compute([T.HourLocal(c).as_("h"), T.DayLocal(c).as_("d")],
                     T.ScanTable(t))


def day_luts(days):
    """numpy datetime64 fields of each day from days.min() to days.max(),
    to gather by ``days - days.min()``: year, month, day of month, the
    same day of the month before (unclamped, as days) and the month
    number since 1970."""
    d0 = int(days.min())
    span = np.arange(d0, int(days.max()) + 1).astype("datetime64[D]")
    months = span.astype("datetime64[M]")
    dom = (span - months.astype("datetime64[D]")).astype(np.int64) + 1
    return days - d0, {
        "y": span.astype("datetime64[Y]").astype(np.int64) + 1970,
        "mo": months.astype(np.int64) % 12 + 1,
        "d": dom,
        "prev": (months - 1).astype("datetime64[D]").astype(np.int64)
        + dom - 1,
        "m": months.astype(np.int64)}


def check_dates(out, t):
    """Path (x), UTC, against numpy's datetime64 of each distinct day:
    every field exact; AddMonths keeps the day of the month unclamped and
    the time of day; DateFormat's codes are those of numpy's "YYYY-MM"
    strings in the sorted dictionary."""
    days = t // 86_400_000_000
    i, lut = day_luts(days)
    got = host_cols(out)
    for k, what in (("y", "Year"), ("mo", "Month"), ("d", "Day")):
        assert np.array_equal(got[k], lut[k][i]), f"(x) {what}"
    assert np.array_equal(got["h"], (t // 3_600_000_000) % 24), "(x) Hour"
    assert np.array_equal(got["wd"], (days + 3) % 7), "(x) Weekday"
    tod = t - days * 86_400_000_000
    assert np.array_equal(got["am"], lut["prev"][i] * 86_400_000_000 + tod), \
        "(x) AddMonths"
    words = out.dicts["ym"].values
    code = {w: k for k, w in enumerate(words)}
    ym = np.array([code.get(f"{m // 12 + 1970:04d}-{m % 12 + 1:02d}", -1)
                   for m in lut["m"]])
    assert np.array_equal(got["ym"], ym[i]), "(x) DateFormat"


def check_local(out, t):
    """Path (x), local: HourLocal and DayLocal against offsets from
    zoneinfo for each distinct UTC hour of the data (New York changes
    offset on the hour), not from the port's day LUT."""
    import datetime
    import zoneinfo

    z = zoneinfo.ZoneInfo(LOCAL_ZONE)
    hour = t // 3_600_000_000
    h0 = int(hour.min())
    offs = np.array([
        datetime.datetime.fromtimestamp(x * 3600, z).utcoffset()
        .total_seconds() for x in range(h0, int(hour.max()) + 1)],
        dtype=np.int64)
    local = t + offs[hour - h0] * 1_000_000
    i, lut = day_luts(local // 86_400_000_000)
    got = host_cols(out)
    assert np.array_equal(got["h"], (local // 3_600_000_000) % 24), \
        "(x) HourLocal"
    assert np.array_equal(got["d"], lut["d"][i]), "(x) DayLocal"
    return int(np.unique(offs).size)


def stateful_data(n=FACT_ROWS, seed=45):
    """Path (y): the stateful golden's columns at n rows: v INT64 (90%
    valid), seq INT32 in 0-2, flush BOOL about once in FLUSH_EVERY rows."""
    rng = np.random.default_rng(seed)
    return {"v": (rng.integers(-10**6, 10**6, n), rng.random(n) < 0.9),
            "seq": rng.integers(0, 3, n).astype(np.int32),
            "flush": rng.random(n) < 1.0 / FLUSH_EVERY}


def stateful_table(T, data, dev):
    """Path (y)'s table of ``stateful_data``."""
    schema = T.TupleSchema.of(("v", T.INT64, True), ("seq", T.INT32, False),
                              ("flush", T.BOOL, False))
    return T.Table.from_numpy(schema, data, device=dev)


def stateful_plan(T, t):
    """Path (y): the stateful golden's plan (tests/test_golden.py:376-395)."""
    c = T.col
    return T.Compute(
        [T.Changed(c("seq")).as_("chg"), T.RunningSum(c("v")).as_("rsum"),
         T.Smudge(c("v")).as_("smu"),
         T.SmudgeIf(c("v"), c("flush")).as_("smuif"),
         T.RunningMinWithFlush(c("flush"), c("v")).as_("rmin")],
        T.ScanTable(t))


def last_true(mask):
    """Index of the last True at or before each row, -1 before the
    first."""
    return np.maximum.accumulate(np.where(mask, np.arange(mask.shape[0]),
                                          -1))


def check_stateful(out, data):
    """Path (y) against numpy (prefix sums, running maxima of indices and
    of segment-coded values): every value and NULL exact."""
    v, ok = data["v"]
    seq, flush = data["seq"], data["flush"]
    n = v.shape[0]

    def col(name):
        c = out.columns[name]
        return (c.values.cpu().numpy(),
                None if c.valid is None else c.valid.cpu().numpy())

    chg, _ = col("chg")
    want = np.ones(n, dtype=bool)
    want[1:] = seq[1:] != seq[:-1]
    assert np.array_equal(chg, want), "(y) Changed"
    rsum, rok = col("rsum")
    assert np.array_equal(rok, np.cumsum(ok) > 0), "(y) RunningSum NULLs"
    assert np.array_equal(rsum[rok], np.cumsum(np.where(ok, v, 0))[rok]), \
        "(y) RunningSum"
    last = last_true(ok)
    smu, sok = col("smu")
    assert np.array_equal(sok, last >= 0), "(y) Smudge NULLs"
    assert np.array_equal(smu[sok], v[last[sok]]), "(y) Smudge"
    keep = ~flush
    lk = last_true(keep)
    si, siok = col("smuif")
    want_ok = np.where(keep, ok, (lk >= 0) & ok[np.maximum(lk, 0)])
    assert np.array_equal(siok, want_ok), "(y) SmudgeIf NULLs"
    want_v = np.where(keep, v, v[np.maximum(lk, 0)])
    assert np.array_equal(si[siok], want_v[siok]), "(y) SmudgeIf"
    # RunningMinWithFlush: segments restart after a flushed row; a running
    # max of (segment, vmax - v) codes is the segment's running min
    reset = np.ones(n, dtype=bool)
    reset[1:] = flush[:-1]
    seg = np.cumsum(reset) - 1
    span = 2 * 10**6 + 2
    code = seg * span + np.where(ok, 1 + (10**6 - v), 0)
    run = np.maximum.accumulate(code) % span
    rm, rmok = col("rmin")
    assert np.array_equal(rmok, run > 0), "(y) RunningMinWithFlush NULLs"
    assert np.array_equal(rm[rmok], 10**6 - (run[rmok] - 1)), \
        "(y) RunningMinWithFlush"
    return int(reset.sum())


def np_mix32(x):
    """murmur3 fmix32 in numpy uint32 arithmetic."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def np_fold32(code):
    """The JAX package's _fold32 in numpy: int32 codes as their low word,
    a float32 as its bits times 31 (plus a zero residual)."""
    if code.dtype == np.float32:
        code = np.where(code == 0, np.float32(0), code)
        return code.view(np.uint32) * np.uint32(31)
    return code.astype(np.uint32)


def hash_plans(T, t):
    """Path (z): Fingerprint(fk, g) and Hash(v) over the headline fact with
    its group; then a group-by keyed by a value computed from a UINT64
    hash (BitwiseAnd(Hash(fk), 63): UINT64 & INT32 promotes to INT64)."""
    c = T.col
    hashes = T.Compute([T.Fingerprint(c("fk"), c("g")).as_("fp"),
                        T.Hash(c("v")).as_("hv")], T.ScanTable(t))
    A = T.Aggregation
    grouped = T.GroupAggregate(
        ["h"], [T.AggSpec(A.COUNT, None, "n")],
        T.Compute([T.BitwiseAnd(T.Hash(c("fk")), T.Const(63)).as_("h")],
                  T.ScanTable(t)))
    return hashes, grouped


def check_hashes(out, grouped, fg):
    """Path (z) against a numpy copy of the mixers: every hash bit for bit,
    every group's count exact."""
    hf = np_mix32(np_fold32(fg["fk"]))
    hg = np_mix32(np_fold32(fg["g"]))
    fp = np_mix32(hf * np.uint32(29) + hg)
    got = host_cols(out)
    assert out.schema.lookup("fp").type.value == "UINT64"
    assert np.array_equal(got["fp"], fp.astype(np.int64)), "(z) Fingerprint"
    assert np.array_equal(got["hv"],
                          np_mix32(np_fold32(fg["v"])).astype(np.int64)), \
        "(z) Hash(v)"
    assert grouped.schema.lookup("h").type.value == "INT64"
    h = (hf & np.uint32(63)).astype(np.int64)
    want = np.bincount(h, minlength=64)
    rows = grouped.to_pylist()
    assert {k: n for k, n in rows} == {k: int(want[k]) for k in
                                       np.flatnonzero(want)}, "(z) group-by"
    return len(rows)


def u64_data(n=FACT_ROWS, seed=46):
    """Path (z)'s sort input: n UINT64 values uniform over [0, 2^64) (half
    of them past 2^63)."""
    return np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64)


def u64_table(T, u, dev):
    """Path (z)'s sort table: ``u64_data`` and each value's row number."""
    schema = T.TupleSchema.of(("u", T.UINT64, False), ("i", T.INT32, False))
    return T.Table.from_numpy(schema, {"u": u, "i": np.arange(
        u.shape[0], dtype=np.int32)}, device=dev)


def check_u64_sort(out, u):
    """Path (z)'s sort: unsigned order, and each row the input row its
    number names (so a permutation of the input)."""
    n = u.shape[0]
    got = out.to_numpy()
    su, si = got["u"], got["i"]
    assert su.dtype == np.uint64 and np.all(su[1:] >= su[:-1]), \
        "(z) UINT64 sort order"
    assert np.array_equal(u[si], su), "(z) UINT64 sort rows"
    assert np.bincount(si, minlength=n).max() == 1, "(z) sort permutation"
    return int((su >= 2**63).sum())


def render_table(T, fact, t, dev, n=RENDER_ROWS):
    """Path (z)'s host render: the first n values of the headline's v and
    of (x)'s instants."""
    schema = T.TupleSchema.of(("v", T.FLOAT, False), ("t", T.DATETIME, False))
    data = {"v": fact["v"][:n], "t": t[:n]}
    return T.Table.from_numpy(schema, data, device=dev), data


def render_plan(T, t):
    """ToString(v) and DateFormat(t) without a domain: rendered per row on
    the host after the run (DeferredRender)."""
    return T.Compute([T.ToString(T.col("v")).as_("sv"),
                      T.DateFormat(T.col("t"), "%Y/%m/%d %a").as_("st")],
                     T.ScanTable(t))


def np_ftoa(f):
    """SimpleFtoa: "%.6g", again at "%.8g" where it does not round trip."""
    d = f.astype(np.float64).tolist()
    s6 = ["%.6g" % x for x in d]
    back = np.array(s6, dtype=object).astype(np.float64).astype(np.float32)
    return [a if b == x else "%.8g" % w
            for a, b, x, w in zip(s6, back.tolist(), f.tolist(), d)]


def check_render(out, data):
    """Path (z)'s render byte for byte on every row: ToString(FLOAT) as
    SimpleFtoa prints, DateFormat as numpy's "%Y/%m/%d %a" of each
    distinct day."""
    got = out.to_numpy()
    sv, st = got["sv"], got["st"]
    assert sv.tolist() == np_ftoa(data["v"]), "(z) ToString(v)"
    days = data["t"] // 86_400_000_000
    d0 = int(days.min())
    span = np.arange(d0, int(days.max()) + 1)
    names = np.array(["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"])
    words = np.char.add(np.char.add(np.char.replace(
        np.datetime_as_string(span.astype("datetime64[D]")), "-", "/"), " "),
        names[(span + 3) % 7])
    assert st.tolist() == words[days - d0].tolist(), "(z) DateFormat"
    return sv.shape[0]


RENDER_ROUTE = ("host: one rendering a distinct value (a float's bits, "
                "a date format's bucket), numpy and Python")


def to_host(T, out):
    """``out``'s live rows copied into a Table on the host, for a check on
    another thread."""
    n = int(out.num_rows)
    cols = {k: T.Column(c.values[:n].cpu(),
                        None if c.valid is None else c.valid[:n].cpu())
            for k, c in out.columns.items()}
    return T.Table(out.schema, cols, n, "cpu", out.dicts)


def slice_phases(T, dev, drive, li, li_t, fact, fg_t, fg):
    """Paths (u)-(z), each from zeroed launch counters and against numpy.
    The inputs are made and the numpy checks run on host threads while
    the card runs the next path (numpy leaves the GIL in its loops); each
    path's result is copied to the host before the next path starts.
    Returns (median plans, the summary line)."""
    from concurrent.futures import ThreadPoolExecutor

    from supersonic_tpu_torch import kernels

    start = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=CHECK_THREADS)
    made = {k: pool.submit(fn) for k, fn in (
        ("u", math_data), ("vw", text_data), ("x", date_data),
        ("y", stateful_data), ("z", u64_data))}
    checks = {}

    def check(name, fn, *args):
        def run():
            t0 = time.perf_counter()
            return fn(*args), time.perf_counter() - t0
        checks[name] = pool.submit(run)

    md = made["u"].result()
    m_t = math_table(T, md, dev)
    first, second = math_plans(T, m_t)
    out1 = to_host(T, drive("(u) Compute c0 * (sin + exp)", first, ()))
    out2 = to_host(T, drive("(u) Compute roundings, cast, LnNulling, Abs",
                            second, ()))
    check("u expr", check_math_expr, out1, md)
    check("u", check_math, out2, md)
    del out1, out2, md
    text = made["vw"].result()
    tx_t = tpch_text_table(T, li_t, text, dev)
    out = drive("(v) TPC-H Q14 promo revenue", q14_plan(T, tx_t),
                ("compaction", "lut_gather"))
    check("v", check_q14, to_host(T, out), li, text)
    out = drive("(w) TPC-H Q12 shape", q12_plan(T, tx_t),
                ("compaction", "lut_gather"))
    w_route = ("dense (segment_reduce)" if kernels.launches[
        "segment_reduce"] else "sort path")
    check("w", check_q12, to_host(T, out), li, text)
    del out, text
    ts = made["x"].result()
    d_t = date_table(T, ts, dev)
    out = drive("(x) dates in UTC", dates_plan(T, d_t), ("lut_gather",))
    check("x UTC", check_dates, to_host(T, out), ts)
    T.set_local_timezone(LOCAL_ZONE)  # raises if the zone cannot load
    try:
        out = drive(f"(x) HourLocal, DayLocal in {LOCAL_ZONE}",
                    local_plan(T, d_t), ("lut_gather",))
    finally:
        T.set_local_timezone(None)
    check("x local", check_local, to_host(T, out), ts)
    sd = made["y"].result()
    s_t = stateful_table(T, sd, dev)
    out = drive("(y) stateful scans", stateful_plan(T, s_t),
                ("compaction", "lut_gather"))
    check("y", check_stateful, to_host(T, out), sd)
    del sd
    hashes, grouped = hash_plans(T, fg_t)
    out = to_host(T, drive("(z) Fingerprint and Hash", hashes, ()))
    gout = to_host(T, drive("(z) group-by of a UINT64 hash", grouped, ()))
    z_route = ("dense (segment_reduce)" if kernels.launches[
        "segment_reduce"] else "sort path")
    check("z hashes", check_hashes, out, gout, fg)
    u = made["z"].result()
    u_t = u64_table(T, u, dev)
    out = drive("(z) Sort of a UINT64 column", T.Sort(["u"], T.ScanTable(u_t)),
                ("lut_gather",))
    check("z sort", check_u64_sort, to_host(T, out), u)
    del u
    r_t, rd = render_table(T, fact, ts, dev)
    out = drive("(z) ToString and DateFormat, host render",
                render_plan(T, r_t), ())
    check("z render", check_render, to_host(T, out), rd)
    del out, rd, ts
    pool.shutdown()
    got = {k: f.result() for k, f in checks.items()}
    n_null, n_v, n_w, n_off, n_seg, n_z, n_big, n_r = (
        got[k][0] for k in ("u", "v", "w", "x local", "y", "z hashes",
                            "z sort", "z render"))
    log(f"(u)-(z): {time.perf_counter() - start:.1f} s on the host clock "
        f"(inputs, first runs and numpy checks); the checks' own s, on "
        f"{CHECK_THREADS} threads: "
        + ", ".join(f"{k} {v[1]:.1f}" for k, v in got.items()))
    summary = (
        f"(u)-(z) match numpy: (u) {MATH_ROWS} rows, sin/exp/ln within "
        f"{TRANSCENDENTAL_RTOL}, the roundings and the cast exact, "
        f"{n_null} NULLs of LnNulling; (v) Q14 over {n_v} rows; "
        f"(w) Q12 {n_w} groups exact, route {w_route}; (x) UTC fields, "
        f"AddMonths and DateFormat exact, {LOCAL_ZONE} hour and day exact "
        f"({n_off} offsets); (y) every stateful column exact, {n_seg} "
        f"flush segments; (z) hashes bit for bit, {n_z} groups, route "
        f"{z_route}; the UINT64 sort ({n_big} values past 2^63) in order; "
        f"{n_r} rows rendered byte for byte, route {RENDER_ROUTE}")
    medians = [
        (lambda: math_plans(T, m_t)[0], "(u) Compute c0 * (sin + exp)",
         f"{MATH_ROWS} rows"),
        (lambda: math_plans(T, m_t)[1], "(u) Compute roundings and friends",
         f"{MATH_ROWS} rows"),
        (lambda: q14_plan(T, tx_t), "(v) TPC-H Q14", f"{FACT_ROWS} rows"),
        (lambda: q12_plan(T, tx_t), f"(w) TPC-H Q12 ({w_route})",
         f"{FACT_ROWS} rows"),
        (lambda: dates_plan(T, d_t), "(x) dates in UTC", f"{FACT_ROWS} rows"),
        (lambda: local_plan(T, d_t),
         f"(x) HourLocal, DayLocal in {LOCAL_ZONE}", f"{FACT_ROWS} rows"),
        (lambda: stateful_plan(T, s_t), "(y) stateful scans",
         f"{FACT_ROWS} rows"),
        (lambda: hash_plans(T, fg_t)[0], "(z) Fingerprint and Hash",
         f"{FACT_ROWS} rows"),
        (lambda: hash_plans(T, fg_t)[1], f"(z) hash group-by ({z_route})",
         f"{FACT_ROWS} rows"),
        (lambda: T.Sort(["u"], T.ScanTable(u_t)), "(z) UINT64 Sort",
         f"{FACT_ROWS} rows"),
        (lambda: render_plan(T, r_t),
         f"(z) host render ({RENDER_ROUTE})",
         f"{RENDER_ROWS} rows"),
    ]
    return medians, summary


# --- paths (aa)-(ac): the columnar files, the spilling group-by and sort ---

SPILL_ROWS = 8_000_000         # (ab), (ac): bench_ops.py's 8M-row fact
SPILL_RUNS = 8                 # (ab) pregroup chunks, (ac) sort runs
TYPES_ROWS = 1_000_000         # (aa): the table of every type
ALL_TYPES = ("INT32", "INT64", "UINT32", "UINT64", "FLOAT", "DOUBLE", "BOOL",
             "DATE", "DATETIME", "STRING", "BINARY", "ENUM", "DATA_TYPE")


def median_of(fn):
    """(median ms, all ms) of REPEATS runs of ``fn`` on the host clock, the
    card synchronized around each."""
    import torch

    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def all_types_table(T, dev, seed=47):
    """(aa)'s third table: one nullable column of each of the 13 types, a
    fifth of the rows NULL, NaNs of both signs, +-0 and infinities among the
    floats, unsigned values past 2^31 and 2^63, a STRING and a BINARY
    column of 1000 values (the empty one included)."""
    rng = np.random.default_rng(seed)
    n = TYPES_ROWS
    arrays, dicts, attrs = {}, {}, []
    words = sorted({""} | {f"w{i:04d}" for i in range(999)})
    for i, t in enumerate(ALL_TYPES):
        name = f"c{i}"
        if t in ("STRING", "BINARY"):
            vals = rng.integers(0, len(words), n).astype(np.int32)
            dicts[name] = T.Dictionary(tuple(
                words if t == "STRING" else sorted(w.encode() for w in words)))
        elif t in ("ENUM", "DATA_TYPE"):
            vals = rng.integers(0, 5, n).astype(np.int32)
        elif t == "BOOL":
            vals = rng.random(n) > 0.5
        elif t in ("FLOAT", "DOUBLE"):
            dt = np.float32 if t == "FLOAT" else np.float64
            vals = rng.standard_normal(n).astype(dt)
            vals[::97] = np.nan
            vals[1::97] = -np.abs(vals[1::97]) * np.inf
            vals[2::97] = -0.0
            bits_ = vals.view(np.int32 if t == "FLOAT" else np.int64)
            bits_[3::97] = np.array(-1, bits_.dtype)  # a NaN of the minus sign
        elif t == "UINT32":
            vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        elif t == "UINT64":
            vals = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
        elif t in ("INT64", "DATETIME"):
            vals = rng.integers(-2**62, 2**62, n)
        else:
            vals = rng.integers(-2**31, 2**31, n).astype(np.int32)
        arrays[name] = (vals, rng.random(n) > 0.2)
        attrs.append(T.Attribute(name, getattr(T.DataType, t), True,
                                 T.EnumDefinition(("a", "b", "c", "d", "e"))
                                 if t == "ENUM" else None))
    return T.Table.from_numpy(T.TupleSchema(attrs), arrays, None, dicts,
                              device=dev)


def same_table(torch, got, want, label):
    """Every live value of ``want`` (bit for bit, NULL rows aside) and every
    NULL in ``got``; STRING/BINARY codes compared through their
    dictionaries.  Returns the NULL count."""
    n = int(want.num_rows)
    assert int(got.num_rows) == n, f"{label}: rows"
    nulls = 0
    for a in want.schema:
        cw, cg = want.columns[a.name], got.columns[a.name]
        ok = (torch.ones(n, dtype=torch.bool, device=cw.values.device)
              if cw.valid is None else cw.valid[:n])
        okg = (torch.ones_like(ok) if cg.valid is None else cg.valid[:n])
        assert torch.equal(ok, okg), f"{label}: NULLs of {a.name}"
        nulls += int((~ok).sum())
        w = bits(cw.values[:n])
        if a.name in want.dicts:
            lut = torch.from_numpy(want.dicts[a.name].codes_in(
                got.dicts[a.name])).to(w.device)
            w = lut[w.long()].to(w.dtype)
        g = bits(cg.values[:n])
        assert torch.equal(torch.where(ok, w, 0), torch.where(ok, g, 0)), \
            f"{label}: values of {a.name}"
    return nulls


def file_round_trips(torch, T, dev, tables, smi, tmp):
    """Path (aa): each (label, table) through ``save`` and
    ``load(device="cuda")`` in ``tmp``: every value and NULL bit-equal to
    the source, then medians of 5 each way and their MB/s."""
    from supersonic_tpu_torch import kernels
    from supersonic_tpu_torch.io import load, save

    lines = []
    for label, t in tables:
        path = str(pathlib.Path(tmp) / "aa.sst")
        kernels.reset_launches()
        save(path, t)
        back = load(path, device=dev)
        launched = dict(kernels.launches)
        nbytes = pathlib.Path(path).stat().st_size
        nulls = same_table(torch, back, t, f"(aa) {label}")
        assert back.device == t.device, f"(aa) {label}: device"
        del back
        save_ms, save_all = median_of(lambda: save(path, t))
        load_ms, load_all = median_of(lambda: load(path, device=dev))
        log(f"(aa) {label}: {int(t.num_rows)} rows, {nbytes} bytes written "
            f"and read; save median {save_ms:.3f} ms "
            f"({nbytes / save_ms / 1e3:.1f} MB/s), load median "
            f"{load_ms:.3f} ms ({nbytes / load_ms / 1e3:.1f} MB/s) over "
            f"{REPEATS} runs after a warm-up (save: "
            f"{', '.join(f'{x:.3f}' for x in save_all)}; load: "
            f"{', '.join(f'{x:.3f}' for x in load_all)}); launches {launched}; "
            f"card: {smi}")
        lines.append(f"{label} {int(t.num_rows)} rows bit for bit, "
                     f"{nulls} NULLs")
        pathlib.Path(path).unlink()
    return "; ".join(lines)


def hybrid_data(fact):
    """Path (ab)'s input: the first 8M rows of (g)'s fk (uniform over 1M
    keys), v and d (the same stream as groupby_hi_tables' d), as
    bench_ops.py:136-140's "groupby 8M->1M keys" holds them."""
    n = SPILL_ROWS
    d = np.random.default_rng(11).random(n) * 2e3 - 1e3
    return {"fk": fact["fk"][:n], "v": fact["v"][:n], "d": d}


def hybrid_plan(T, t, quota, tmp):
    """Path (ab): (g)'s aggregates as a HybridGroupAggregate under a
    memory_quota of ``quota`` bytes."""
    A = T.Aggregation
    return T.HybridGroupAggregate(
        ["fk"], [T.AggSpec(A.SUM, "v", "sv"), T.AggSpec(A.COUNT, None, "c"),
                 T.AggSpec(A.SUM, "d", "sd"), T.AggSpec(A.MAX, "v", "mx")],
        T.ScanTable(t), T.GroupAggregateOptions(
            memory_quota=quota, estimated_result_row_count=HI_KEYS),
        temporary_directory_prefix=tmp)


def hybrid_quota(T, t, rows):
    """The memory_quota in bytes that ``_quota_rows`` turns into ``rows``
    pregroup rows: the pregroup row's width (each value's bytes and a
    validity byte a nullable column) times ``rows``."""
    from supersonic_tpu_torch.ops.aggregate import (_quota_rows,
                                                    _resolve_output_attr)
    specs = hybrid_plan(T, t, 1, None).spec.specs
    pre = T.TupleSchema([t.schema.lookup("fk")] + [
        _resolve_output_attr(s, t.schema) for s in specs])
    width = sum(T.types.physical_dtype(a.type).itemsize + a.nullable
                for a in pre)
    assert _quota_rows(width * rows, pre) == rows
    return width * rows


def check_hybrid(out, plain, data):
    """Path (ab) against numpy and against the same plan without a quota:
    keys in ascending order and exact, counts exact, f32 sums within
    SUM_RTOL, DOUBLE sums within DOUBLE_RTOL of their sum of |d|, MAX bit
    for bit.  Returns the group count."""
    keys, counts, sv, sd, sad, mx = groupby_hi_want(data["fk"], data["v"],
                                                    data["d"])
    order = np.argsort(keys, kind="stable")
    keys, counts, sv, sd, sad, mx = (x[order] for x in
                                     (keys, counts, sv, sd, sad, mx))
    got = host_cols(out)
    assert np.array_equal(got["fk"], keys), "(ab): keys"
    assert np.array_equal(got["c"], counts), "(ab): counts"
    assert np.all(np.abs(got["sv"] - sv) <= SUM_RTOL * np.abs(sv)), "(ab): sv"
    assert np.all(np.abs(got["sd"] - sd) <= DOUBLE_RTOL * sad), "(ab): sd"
    assert np.array_equal(got["mx"].view(np.int32), mx.view(np.int32)), \
        "(ab): mx"
    ref = host_cols(plain)
    by_key = np.argsort(ref["fk"], kind="stable")
    assert np.array_equal(ref["fk"][by_key], got["fk"]), "(ab): plain keys"
    assert np.array_equal(ref["c"][by_key], got["c"]), "(ab): plain counts"
    assert np.array_equal(ref["mx"][by_key].view(np.int32),
                          got["mx"].view(np.int32)), "(ab): plain mx"
    assert np.all(np.abs(ref["sv"][by_key] - got["sv"])
                  <= SUM_RTOL * np.abs(sv)), "(ab): plain sv"
    return keys.shape[0]


def spill_sort_plan(T, t, limit, tmp):
    """Path (ac): bench_ops.py:143-145's "sort 8M by (g,v)", g ASC and v
    DESC, as a SortWithTempDirPrefix under ``limit`` bytes."""
    return T.SortWithTempDirPrefix(
        [T.SortKey("g", True), T.SortKey("v", False)], T.ScanTable(t),
        memory_limit=limit, temporary_directory_prefix=tmp)


def check_spill_sort(torch, out, t):
    """Path (ac): g and v bit for bit the in-memory Sort's, and the rows
    (g, fk, v) the input's multiset (ties across runs go by partition)."""
    import supersonic_tpu_torch as T

    mem = T.execute(T.Sort([T.SortKey("g", True), T.SortKey("v", False)],
                           T.ScanTable(t)))
    n = int(t.num_rows)
    assert int(out.num_rows) == n, "(ac): rows"
    for c in ("g", "v"):
        assert torch.equal(bits(out.columns[c].values[:n]),
                           bits(mem.columns[c].values[:n])), f"(ac): {c}"
    a, b = host_cols(out), host_cols(t)
    for x in (a, b):
        x["o"] = np.lexsort((x["fk"], x["v"].view(np.int32), x["g"]))
    for c in ("g", "fk", "v"):
        assert np.array_equal(a[c][a["o"]], b[c][b["o"]]), \
            f"(ac): rows ({c})"
    return n


def spill_phases(torch, T, dev, drive, smi, fact, fact_t, str_dim_t, fg):
    """Paths (aa)-(ac), each from zeroed launch counters and against numpy,
    in a temporary directory removed at the end.  Returns the summary."""
    import tempfile

    from supersonic_tpu_torch import native
    from supersonic_tpu_torch.io import external
    from supersonic_tpu_torch.ops.sort import sort_working_set_bytes

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        types_t = all_types_table(T, dev)
        aa = file_round_trips(torch, T, dev, (
            ("headline fact", fact_t), ("(m)'s join_str dim", str_dim_t),
            ("every type", types_t)), smi, tmp)
        del types_t
        assert native.available(), "(ab), (ac): the C++ merge did not build"
        hd = hybrid_data(fact)
        h_t = T.Table.from_numpy(
            T.TupleSchema.of(("fk", T.INT32, False), ("v", T.FLOAT, False),
                             ("d", T.DOUBLE, False)), hd, device=dev)
        quota = hybrid_quota(T, h_t, SPILL_ROWS // SPILL_RUNS)
        external.reset_disk_bytes()
        out = drive("(ab) HybridGroupAggregate spilling",
                    hybrid_plan(T, h_t, quota, tmp),
                    ("compaction", "lut_gather"))
        disk_ab = dict(external.disk_bytes)
        assert disk_ab["written"] > 0, "(ab): no run spilled"
        n_ab = check_hybrid(out, T.execute(groupby_hi_plan(T, h_t)), hd)
        del out
        ab_ms, ab_all = median_of(lambda: T.execute(
            hybrid_plan(T, h_t, quota, tmp)))
        log(f"(ab) HybridGroupAggregate {SPILL_ROWS} -> {n_ab} keys, quota "
            f"{quota} bytes ({SPILL_ROWS // SPILL_RUNS} pregroup rows): "
            f"median {ab_ms:.3f} ms over {REPEATS} runs after a warm-up "
            f"(all: {', '.join(f'{x:.3f}' for x in ab_all)}); disk "
            f"{disk_ab['written']} bytes written, {disk_ab['read']} read; "
            f"card: {smi}")
        del h_t
        s_t = T.Table.from_numpy(
            T.TupleSchema.of(("g", T.INT32, False), ("fk", T.INT32, False),
                             ("v", T.FLOAT, False)),
            {k: v[:SPILL_ROWS] for k, v in fg.items()}, device=dev)
        limit = sort_working_set_bytes(s_t.schema, s_t.capacity, 2) \
            // SPILL_RUNS
        external.reset_disk_bytes()
        out = drive("(ac) SortWithTempDirPrefix spilling",
                    spill_sort_plan(T, s_t, limit, tmp), ("lut_gather",))
        disk_ac = dict(external.disk_bytes)
        assert disk_ac["written"] > 0, "(ac): no run spilled"
        n_ac = check_spill_sort(torch, out, s_t)
        del out
        ac_ms, ac_all = median_of(lambda: T.execute(
            spill_sort_plan(T, s_t, limit, tmp)))
        log(f"(ac) SortWithTempDirPrefix {SPILL_ROWS} rows by (g ASC, v "
            f"DESC), memory_limit {limit} bytes: median {ac_ms:.3f} ms over "
            f"{REPEATS} runs after a warm-up (all: "
            f"{', '.join(f'{x:.3f}' for x in ac_all)}); disk "
            f"{disk_ac['written']} bytes written, {disk_ac['read']} read; "
            f"card: {smi}")
        left = list(pathlib.Path(tmp).iterdir())
        assert not left, f"(ab), (ac): spill files left behind: {left}"
    log(f"(aa)-(ac): {time.perf_counter() - start:.1f} s on the host clock")
    return (f"(aa)-(ac) match numpy: (aa) {aa}; (ab) {n_ab} keys in order, "
            f"counts and MAX exact, sums within tolerance, equal to the plan "
            f"without a quota; (ac) {n_ac} rows in the in-memory Sort's key "
            f"order, the same multiset")


def stat_rows(node):
    """(name, rows_processed) of every node of a harness tree, in
    pre-order."""
    out = [(node.name, node.rows_processed)]
    for k in node.children:
        out += stat_rows(k)
    return out


def tooling_phases(torch, T, dev, smi, total, fact, dim, fact_t, dim_t):
    """Paths (ad)-(ag), each from zeroed launch counters (added to
    ``total``) and against numpy: (ad) the benchmark harness over the
    headline plan at 100M x 1M, every node's rows equal to numpy's; (ae)
    the headline twin at its own 8M x 1M, its JSON line; (af) ``entry()``
    on the card against ``entry(device="cpu")``; (ag) distribution at
    world size 1 over NCCL on this card: ``dryrun(1)``, then the headline
    through ``dist_map`` (Filter), ``dist_hash_join``,
    ``dist_group_aggregate`` and ``dist_sort`` at 100M x 1M against the
    single-card headline, its median of 5, launches and exchange bytes.
    The process group is destroyed at the end.  Returns the summary."""
    from supersonic_tpu_torch import kernels
    from supersonic_tpu_torch import parallel as D
    from supersonic_tpu_torch.bench import benchmark_plan, format_stats
    from supersonic_tpu_torch.bench import headline as H
    from supersonic_tpu_torch.entry import entry
    from supersonic_tpu_torch.parallel import dist as DD

    start = time.perf_counter()

    def counted(label, fn, needs):
        """Run ``fn`` from zeroed counters; every kernel in ``needs``
        must have launched."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(kernels.launches)
        for k in got:
            total[k] += got[k]
        log(f"main path launches, {label}: {got}")
        for k in needs:
            assert got[k] > 0, f"{label} did not launch {k}"
        return out, got

    # (ad) the harness: per-node rows and times of the headline plan
    stats, _ = counted("(ad) benchmark_plan of the headline query",
                       lambda: benchmark_plan(headline_plan(T, fact_t,
                                                            dim_t)),
                       ("compaction", "lut_gather", "segment_reduce"))
    keep = fact["v"] > 0.5
    n_keep = int(keep.sum())
    groups = int(np.unique(dim["g"][fact["fk"][keep]]).size)
    want = [("Sort", groups), ("GroupAggregate", groups),
            ("HashJoin", n_keep), ("Filter", n_keep),
            ("ScanTable", FACT_ROWS), ("ScanTable", DIM_ROWS)]
    assert stat_rows(stats) == want, f"(ad): {stat_rows(stats)} != {want}"
    join = stats.children[0].children[0]
    assert join.index_set_up_time_us is not None \
        and join.matching_time_us is not None, "(ad): no join phase split"
    log(f"(ad) format_stats of the headline query, {FACT_ROWS} x "
        f"{DIM_ROWS} (CUDA events, best of 3; card: {smi}):\n"
        f"{format_stats(stats)}")

    # (ae) the headline twin, bench.py's 8M x 1M
    rec, _ = counted("(ae) bench.headline", lambda: H.measure(
        device=dev, log=log), ("segment_reduce", "lut_gather"))
    log(f"(ae) headline twin JSON line: {json.dumps(rec)} (card: {smi})")

    # (af) entry() on the card
    (sv, n, flags), _ = counted("(af) entry", lambda: (lambda fn, a: fn(*a))(
        *entry(dev)), ("lut_gather", "segment_reduce"))
    cpu_sv, cpu_n, _ = (lambda fn, a: fn(*a))(*entry("cpu"))
    assert int(n) == int(cpu_n) == GROUPS and not bool(flags.any()), \
        "(af): rows or flags"
    np.testing.assert_allclose(sv[:int(n)].cpu().numpy(),
                               cpu_sv[:int(n)].numpy(), rtol=1e-5)
    log(f"(af) entry() on {dev}: sv {tuple(sv.shape)} {sv.dtype}, num_rows "
        f"{tuple(torch.as_tensor(n).shape)} = {int(n)}, flags "
        f"{tuple(flags.shape)}; sv equals entry(device=\"cpu\")'s (rtol 1e-5)")

    # (ag) distribution at world size 1 over NCCL (no fallback: a failed
    # NCCL initialisation fails the smoke)
    D.initialize(f"localhost:{D.multihost.free_port()}", 1, 0, device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl", "(ag): backend"
        t0 = time.perf_counter()
        _, dry = counted("(ag) dryrun(1)", lambda: D.dryrun(1),
                         ("compaction", "lut_gather"))
        dry_s = time.perf_counter() - t0
        mesh = D.make_mesh(1)
        opts = T.GroupAggregateOptions(estimated_result_row_count=GROUPS)

        def dist_headline(stats=None):
            dfact = D.distribute_table(fact_t, mesh)
            ddim = D.distribute_table(dim_t, mesh, keys=["pk"])
            filtered = D.dist_map(mesh, lambda t: D.run_local_plan(
                lambda tt: T.Filter(T.col("v") > T.Const(0.5, T.FLOAT),
                                    T.ScanTable(tt)), t), dfact)
            if stats is not None:  # the join's probe exchange, counted
                D.shuffle(mesh, filtered, DD._key_dest_fn(["fk"], 1),
                          stats_out=stats)
            joined = D.dist_hash_join(
                mesh, T.JoinType.INNER, ["fk"], ["pk"], filtered, ddim,
                T.KeyUniqueness.UNIQUE,
                lhs_projector=T.Projector.named("v"),
                rhs_projector=T.Projector.named("g"))
            agg = D.dist_group_aggregate(
                mesh, joined, ["g"],
                [T.AggSpec(T.Aggregation.SUM, "v", "sv"),
                 T.AggSpec(T.Aggregation.COUNT, None, "c")], opts)
            return D.collect_table(D.dist_sort(
                mesh, agg, [T.SortKey("sv", ascending=False)]), mesh)

        ex = {}
        out, dist_launches = counted(
            "(ag) distributed headline", lambda: dist_headline(ex),
            ("compaction", "lut_gather"))
        n_ag = check_headline(out, fact, dim)
        single = T.execute(headline_plan(T, fact_t, dim_t)).to_pylist()
        got = out.to_pylist()
        assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in single], \
            "(ag): keys, counts or order differ from the single-card headline"
        np.testing.assert_allclose([r[1] for r in got], [r[1] for r in single],
                                   rtol=SUM_RTOL)
        del out
        ag_ms, ag_all = median_of(dist_headline)
        log(f"(ag) distributed headline, {FACT_ROWS} x {DIM_ROWS} at world "
            f"size 1 over NCCL: median {ag_ms:.3f} ms over {REPEATS} runs "
            f"after a warm-up (all: {', '.join(f'{x:.3f}' for x in ag_all)}; "
            f"distribute_table to collect_table); launches {dist_launches}; "
            f"the probe exchange moved {ex['total_bytes']} bytes "
            f"({ex['row_bytes']} a row, sent_rows {ex['sent_rows'].tolist()}, "
            f"off the card {ex['offmesh_bytes']}); dryrun(1) "
            f"{dry_s:.1f} s, launches {dry}; card: {smi}")
    finally:
        torch.distributed.destroy_process_group()
    log(f"(ad)-(ag): {time.perf_counter() - start:.1f} s on the host clock")
    return (f"(ad)-(ag) match numpy: (ad) every node's rows ({want}), the "
            f"join's phase split; (ae) {rec['metric']} {rec['value']:.1f} "
            f"{rec['unit']}, {rec['vs_baseline']:.3f}x numpy, result checked; "
            f"(af) entry() equals the CPU's; (ag) dryrun(1) and the "
            f"distributed headline's {n_ag} groups equal the single-card "
            f"headline's in order")


# --- paths (ah)-(al): the twins of bench_ops.py, scripts/bench_configs.py,
# scripts/stress_edges.py, examples/operation_example.py and bench_dist.py --

OPS_SIZE = (8_000_000, 1_000_000)               # (ah): bench_ops.py's n, m
CONFIG_SIZE = (10_000_000, 100_000_000, 1_000_000)  # (ai): n10, n100, m
STRESS_SMALL = False                            # (aj): full size, 17M rows
EXAMPLE_ROWS = 100_000                          # (ak): its default rows
DIST_SIZE = (1_000_000, 100_000)                # (al): EXCHANGE.json's
# kernels each plan must launch at these sizes
OPS_NEEDS = {
    "filter": ("compaction",), "filter_f64": ("compaction",),
    "groupby": ("segment_reduce",), "groupby_hi": ("compaction",),
    "sort": ("lut_gather",), "join": ("compaction", "lut_gather"),
    "join_merge": ("compaction", "lut_gather"),
    "join_multi": ("compaction", "lut_gather", "spread"),
    "join_wide": ("compaction", "lut_gather"),
    "join_dup8": ("compaction", "lut_gather", "spread"),
    "join_left": ("lut_gather",), "groupby_str": ("segment_reduce",),
    "compute": (), "join_str": ("compaction", "lut_gather"),
    "merge_union": ("merge_sorted",)}
CONFIG_NEEDS = {"config2_50": ("segment_reduce",),
                "config2_hi": ("compaction", "lut_gather"),
                "config3_sort": ("lut_gather",),
                "config4_join": ("compaction", "lut_gather")}


def twin_line(tag, label, t, rows, smi):
    """A twin's timing: best and median of its timed runs on the host
    clock, best CUDA-event time, the first run."""
    dev = "" if t.device_s is None else \
        f", CUDA events best {t.device_s * 1e3:.3f} ms"
    return (f"{tag} {label}: best {t.host_s * 1e3:.3f} ms, median "
            f"{statistics.median(t.all_s) * 1e3:.3f} ms of {len(t.all_s)} "
            f"(all: {', '.join(f'{x * 1e3:.3f}' for x in t.all_s)}){dev}; "
            f"first run {t.first_s * 1e3:.1f} ms; "
            f"{rows / t.host_s / 1e6:.1f} M rows/s; card: {smi}")


def twin_phases(torch, T, dev, smi, total):
    """Paths (ah)-(al), each plan from zeroed launch counters (added to
    ``total``) and against numpy: (ah) the fifteen plans of
    ``bench/ops.py`` at 8M x 1M (join_merge through the merge probe, the
    plain join not); (ai) the four configs of ``bench/configs.py`` at 10M,
    100M and 100M x 1M; (aj) ``bench/stress_edges.py``'s three cases at
    full size, overflow flags off; (ak) ``examples/operation_example.py``'s
    five workloads at 100k rows, their DOT files written; (al)
    ``bench/dist.py``'s ``run`` and ``analyze`` at world size 1 over NCCL at
    1M x 100k, the result rows equal to the single-card plan's and numpy's,
    the exchanges equal to ``EXCHANGE.json``'s P = 1 record.  Returns the
    summary."""
    import contextlib
    import io
    import tempfile

    from supersonic_tpu_torch import kernels
    from supersonic_tpu_torch import parallel as D
    from supersonic_tpu_torch.bench import configs as C
    from supersonic_tpu_torch.bench import dist as BD
    from supersonic_tpu_torch.bench import headline as H
    from supersonic_tpu_torch.bench import ops as O
    from supersonic_tpu_torch.bench import stress_edges as SE
    from supersonic_tpu_torch.examples import operation_example as OE
    from supersonic_tpu_torch.ops import hash_join as HJ

    start = time.perf_counter()
    phase = {}  # tag -> launches summed over the phase's counted runs

    def counted(label, tag, fn, needs):
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(kernels.launches)
        sums = phase.setdefault(tag, dict.fromkeys(got, 0))
        for k in got:
            total[k] += got[k]
            sums[k] += got[k]
        log(f"main path launches, {label}: {got}")
        for k in needs:
            assert got[k] > 0, f"{label} did not launch {k}"
        return out

    def phase_done(tag, t0):
        log(f"{tag}: {time.perf_counter() - t0:.1f} s on the host clock; "
            f"launches {phase[tag]}")

    # (ah) bench_ops.py's fifteen plans
    t0 = time.perf_counter()
    data = O.build_data(*OPS_SIZE)
    plans = O.build_plans(T, device=dev, data=data)
    log(f"(ah) data and tables, {OPS_SIZE[0]} x {OPS_SIZE[1]}: "
        f"{time.perf_counter() - t0:.1f} s")
    merge_probes = []
    orig = HJ._merge_probe

    def merge_probe(*a, **kw):
        merge_probes.append(1)
        return orig(*a, **kw)

    HJ._merge_probe = merge_probe
    try:
        for key, (label, plan, rows) in plans.items():
            before = len(merge_probes)
            out = counted(f"(ah) {label}", "(ah)", lambda: T.execute(plan),
                          OPS_NEEDS[key])
            if key in ("join", "join_merge"):
                took = len(merge_probes) > before
                assert took == (key == "join_merge"), \
                    f"(ah) {key}: merge probe taken: {took}"
            n = O.check(key, out, data)
            del out
            log(twin_line("(ah)", label, O.time_plan(T, plan, REPEATS), rows,
                          smi) + f"; {n} rows match numpy")
    finally:
        HJ._merge_probe = orig
    del data, plans
    phase_done("(ah)", t0)

    # (ai) scripts/bench_configs.py's configs 2-4, one at a time
    t0 = time.perf_counter()
    for key, label, plan, rows, data in C.build_configs(T, *CONFIG_SIZE,
                                                        device=dev):
        out = counted(f"(ai) {label}", "(ai)", lambda: T.execute(plan),
                      CONFIG_NEEDS[key])
        n = C.check(key, out, data)
        del out
        log(twin_line("(ai)", label, O.time_plan(T, plan, REPEATS), rows,
                      smi) + f"; {n} rows match numpy")
        del plan, data
    phase_done("(ai)", t0)

    # (aj) the capacity edges, each case checked by the twin
    t0 = time.perf_counter()
    stress = counted("(aj) stress_edges", "(aj)",
                     lambda: SE.main(STRESS_SMALL, dev, log),
                     ("compaction", "lut_gather", "spread"))
    phase_done("(aj)", t0)

    # (ak) the reference's example workloads under the harness
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dot_") as tmp:
        stats = counted("(ak) operation_example", "(ak)",
                        lambda: OE.main(EXAMPLE_ROWS, tmp, dev, log),
                        ("compaction", "lut_gather", "merge_sorted"))
        for name in OE.NAMES:
            dot = (pathlib.Path(tmp) / f"{name}.dot").read_text()
            assert dot.startswith(f'digraph "{name}"'), f"(ak) {name}.dot"
    ak_rows = {k: s.rows_processed for k, s in stats.items()}
    ak_ms = {k: round(s.subtree_time_us / 1e3, 3) for k, s in stats.items()}
    log(f"(ak) operation_example, {EXAMPLE_ROWS} rows: rows {ak_rows}; "
        f"whole-plan ms (CUDA events, one run after a warm-up) {ak_ms}; "
        f"each workload matches numpy, DOT written; card: {smi}")
    phase_done("(ak)", t0)

    # (al) bench_dist.py's run and analyze at world size 1 (no fallback: a
    # failed NCCL initialisation fails the smoke)
    t0 = time.perf_counter()
    record = json.loads((pathlib.Path(__file__).resolve().parent
                         / "EXCHANGE.json").read_text())
    assert (record["fact_rows"], record["dim_rows"]) == DIST_SIZE
    D.initialize(f"localhost:{D.multihost.free_port()}", 1, 0,
                 device=dev.type)
    printed = io.StringIO()
    try:
        if dev.type == "cuda":
            assert torch.distributed.get_backend() == "nccl", "(al): backend"
        with contextlib.redirect_stdout(printed):
            run = counted("(al) bench.dist run", "(al)", lambda: BD.run(
                *DIST_SIZE, 1, dev, reps=REPEATS, log=log),
                ("compaction", "lut_gather"))
            ana = counted("(al) bench.dist analyze", "(al)",
                          lambda: BD.analyze(*DIST_SIZE, 1, dev,
                                             reps=REPEATS, out=None,
                                             log=log),
                          ("compaction", "lut_gather"))
    finally:
        torch.distributed.destroy_process_group()
        for ln in printed.getvalue().splitlines():
            log(f"(al) {ln}")
    assert run["record"]["value"] is None, "(al): efficiency at one rank"
    fact, dim = H.build_data(*DIST_SIZE)
    sums, counts, _ = H.numpy_pipeline(fact, dim)
    single = T.execute(BD.local_plan(
        T, *H.build_tables(T, fact, dim, dev))).to_pylist()
    got = run["per_P"][1]["rows"]
    want = [(k, int(counts[k])) for k in np.flatnonzero(counts)]
    assert [(r[0], r[2]) for r in got] == want, "(al): keys or counts"
    assert [(r[0], r[2]) for r in single] == want, "(al): single-card plan"
    np.testing.assert_allclose([r[1] for r in got], sums[counts > 0],
                               rtol=SUM_RTOL)
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in single],
                               rtol=SUM_RTOL)
    assert ana["per_P"] == {"1": record["per_P"]["1"]}, \
        f"(al): exchanges {ana['per_P']} != {record['per_P']['1']}"
    times = ana["times"][1]
    log(f"(al) bench.dist at world size 1, {DIST_SIZE[0]} x {DIST_SIZE[1]}: "
        f"the pipeline best {run['per_P'][1]['seconds'] * 1e3:.3f} ms of "
        f"{REPEATS} between barriers; components (best of {REPEATS}, ms): "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items())
        + f"; exchanges equal EXCHANGE.json's P = 1; card: {smi}")
    phase_done("(al)", t0)
    log(f"(ah)-(al): {time.perf_counter() - start:.1f} s on the host clock")
    return (f"(ah)-(al) match numpy: (ah) {len(O.LABELS)} bench_ops plans, "
            f"join_merge through the merge probe; (ai) {len(C.LABELS)} "
            f"configs; (aj) {len(stress)} capacity edges, overflow flags "
            f"off; (ak) {len(stats)} example workloads, DOT written; (al) "
            f"run's {len(got)} groups equal the single-card plan's, the "
            f"efficiency undefined at one rank, analyze's exchanges equal "
            f"EXCHANGE.json's P = 1 record")


# --- path (am): the card's route against the CPU route ----------------------

FUZZ_SEEDS = 200      # (am): seeded random plans, tests/torch_fuzz.py ...
FUZZ_SECONDS = 30.0   # ... or as many as this many seconds hold
AM_KERNELS = ("compaction", "lut_gather", "segment_reduce", "spread",
              "merge_sorted")


def fuzz_plans(T, dev):
    """(am)'s seeded random plans (``tests/torch_fuzz.py``) at the kernels'
    tile row counts, read from ``csrc``: each plan on the card and on the
    CPU from the same numpy data, compared by ``compare_results`` (rows in
    order, values bit for bit, float SUMs within their order bound, the
    same exception where the CPU raises).  Returns (plans, rows compared,
    mismatches, the plans of each family, the plans that raise, the row
    counts)."""
    import torch_fuzz as F

    sizes = F.tile_row_counts(pathlib.Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    plans = rows = raises = 0
    bad, families = [], {}
    for seed in range(FUZZ_SEEDS):
        if time.perf_counter() - t0 > FUZZ_SECONDS:
            break
        case = F.random_case(seed, sizes)
        want = F.run_case(T, case, "cpu")
        n, err = F.compare_results(case, want, F.run_case(T, case, dev))
        plans += 1
        rows += n
        raises += want[0] == "raises"
        families[case.family] = families.get(case.family, 0) + 1
        if err:
            bad.append(f"seed {seed}, {case.family} {case.note} "
                       f"{[s.n for s in case.specs]} rows: {err}")
    return plans, rows, bad, families, raises, sizes


def suite_edges(T, dev):
    """The cases of tests/test_differential_sweep.py and
    tests/test_capacity_edges.py on the card, held to the expectations of
    the port's CPU tests (tests/test_torch_tooling.py,
    tests/test_torch_joins.py): Filter, Sort, GroupAggregate and UNIQUE
    joins against the port's row model through ``check_operation``'s
    capacity sweep; high-duplication NOT_UNIQUE expansion at 100% and
    ~104% of out_capacity, and past it; the NOT_UNIQUE join at 91%, 97%
    and 100% of out_capacity and one row short; the group extraction at a
    capacity past 2^24.  Returns the count of cases."""
    from supersonic_tpu_torch.reference import ref_engine as ref
    from supersonic_tpu_torch.testing import check_operation
    from torch_fuzz import sweep_data, sweep_rows

    A, JT, KU = T.Aggregation, T.JoinType, T.KeyUniqueness
    schema = T.TupleSchema.of(("k", T.INT64), ("v", T.INT64),
                              ("x", T.DOUBLE), ("s", T.STRING))
    rs = T.TupleSchema.of(("pk", T.INT64, False), ("w", T.INT64))
    cases = 0

    def check(*a):
        nonlocal cases
        check_operation(*a, device=dev.type)
        cases += 1

    for seed, n in ((0, 1000), (1, 2500), (2, 777)):
        data = sweep_data(np.random.default_rng(seed + 100), n)
        check(lambda t: T.Filter(T.col("v") > 0, T.ScanTable(t)),
              [(schema, data)], ref.filter_rows(
                  sweep_rows(data, n),
                  lambda r: None if r[1] is None else r[1] > 0))
    for seed, n in ((0, 1200), (1, 3000)):
        data = sweep_data(np.random.default_rng(seed + 110), n)
        check(lambda t: T.Sort([("k", True), T.SortKey("x", ascending=False)],
                               T.ScanTable(t)), [(schema, data)],
              ref.sort_rows(sweep_rows(data, n), [(0, True), (2, False)]))
    for seed, n in ((0, 1500), (1, 4000)):
        data = sweep_data(np.random.default_rng(seed + 120), n, key_dom=60)
        check(lambda t: T.GroupAggregate(
            ["k"], [T.AggSpec(A.SUM, "v", "sv"), T.AggSpec(A.MIN, "v", "mn"),
                    T.AggSpec(A.MAX, "v", "mx"), T.AggSpec(A.COUNT, "x", "cx"),
                    T.AggSpec(A.COUNT, None, "c")], T.ScanTable(t)),
              [(schema, data)], ref.group_aggregate(
                  sweep_rows(data, n), [0],
                  [("sum", 1), ("min", 1), ("max", 1), ("count", 2),
                   ("count_star", None)]))
    for jt in (JT.INNER, JT.LEFT_OUTER):
        for dense in (True, False):
            rng = np.random.default_rng(130)
            data = sweep_data(rng, 1200, key_dom=40)
            rdata = {"pk": rng.choice(60, size=25, replace=False).tolist(),
                     "w": rng.integers(0, 100, 25).tolist()}
            check(lambda lt, rt: T.HashJoin(
                jt, ["k"], ["pk"], T.ScanTable(lt), T.ScanTable(rt),
                KU.UNIQUE, allow_dense_lookup=dense),
                [(schema, data), (rs, rdata)], ref.hash_join(
                    sweep_rows(data, 1200), list(zip(rdata["pk"],
                                                     rdata["w"])), 0, 0,
                    jt == JT.LEFT_OUTER, rhs_width=2))

    def table(s, d, **kw):
        return T.Table.from_data(s, d, device=dev, **kw)

    # high-duplication NOT_UNIQUE expansion at and near out_capacity
    for dense in (True, False):
        rng = np.random.default_rng(140)
        data = sweep_data(rng, 800, null_p=0.05, key_dom=10)
        rdata = {"pk": np.repeat(np.arange(10), 6).tolist(),
                 "w": rng.integers(0, 100, 60).tolist()}
        exp = ref.hash_join(sweep_rows(data, 800), list(zip(
            rdata["pk"], rdata["w"])), 0, 0, False, rhs_width=2)
        for cap in (len(exp), int(len(exp) * 1.04)):
            got = T.execute(T.HashJoin(
                JT.INNER, ["k"], ["pk"], T.ScanTable(table(schema, data)),
                T.ScanTable(table(rs, rdata)), KU.NOT_UNIQUE,
                out_capacity=cap, allow_dense_lookup=dense)).to_pylist()
            assert got == exp, f"(am) NOT_UNIQUE expansion, cap {cap}"
            cases += 1
    rng = np.random.default_rng(150)
    data = sweep_data(rng, 500, null_p=0.0, key_dom=5)
    rdata = {"pk": np.repeat(np.arange(5), 4).tolist(), "w": list(range(20))}
    exact = len(ref.hash_join(sweep_rows(data, 500), list(zip(
        rdata["pk"], rdata["w"])), 0, 0, False, rhs_width=2))
    expect_overflow(T, T.HashJoin(
        JT.INNER, ["k"], ["pk"], T.ScanTable(table(schema, data)),
        T.ScanTable(table(rs, rdata)), KU.NOT_UNIQUE,
        out_capacity=exact - 10), "(am) differential overflow")
    cases += 1

    # tests/test_capacity_edges.py: 200 probe rows x 4 build rows a key
    rng = np.random.default_rng(0)
    probe = table(T.TupleSchema.of(("fk", T.INT64, False),
                                   ("pv", T.INT64, False)),
                  {"fk": rng.integers(0, 20, 200), "pv": np.arange(200)})
    build = table(T.TupleSchema.of(("bk", T.INT64, False),
                                   ("bv", T.INT64, False)),
                  {"bk": np.repeat(np.arange(20), 4), "bv": np.arange(80)})
    bmap: dict = {}
    for bk, bv in build.to_pylist():
        bmap.setdefault(bk, []).append(bv)
    want = sorted((k, pv, k, bv) for k, pv in probe.to_pylist()
                  for bv in bmap.get(k, []))
    for fill in (0.91, 0.97, 1.0):
        out = T.execute(T.HashJoin(
            JT.INNER, ["fk"], ["bk"], T.ScanTable(probe), T.ScanTable(build),
            KU.NOT_UNIQUE, out_capacity=int(np.ceil(800 / fill))))
        assert int(out.num_rows) == 800, f"(am) fill {fill}: rows"
        assert sorted(out.to_pylist()) == want, f"(am) fill {fill}: rows"
        cases += 1
    expect_overflow(T, T.HashJoin(
        JT.INNER, ["fk"], ["bk"], T.ScanTable(probe), T.ScanTable(build),
        KU.NOT_UNIQUE, out_capacity=799), "(am) one row past out_capacity")
    cases += 1
    rng = np.random.default_rng(2)
    k, v = rng.integers(0, 37, 4096), rng.integers(0, 100, 4096)
    out = T.execute(T.GroupAggregate(
        ["k"], [T.AggSpec(A.SUM, "v", "sv")], T.ScanTable(table(
            T.TupleSchema.of(("k", T.INT64, False), ("v", T.INT64, False)),
            {"k": k, "v": v}, capacity=(1 << 24) + 64)),
        T.GroupAggregateOptions(estimated_result_row_count=64)))
    sums: dict = {}
    for ki, vi in zip(k.tolist(), v.tolist()):
        sums[ki] = sums.get(ki, 0) + vi
    assert dict(out.to_pylist()) == sums, "(am) extraction past 2^24"
    return cases + 1


def expect_overflow(T, plan, what):
    try:
        T.execute(plan)
    except T.EvaluationError as e:
        assert str(e) == "evaluation failed: join result overflow", \
            f"{what}: {e}"
        return
    raise AssertionError(f"{what}: no overflow raised")


def flip_after(T, n):
    """tests/test_errors.py's FlipAfter: a token whose ``interrupted()``
    turns true at its (n + 1)-th poll, counting its polls."""
    class FlipAfter(T.CancellationToken):
        __slots__ = ("n", "polls")

        def __init__(self):
            super().__init__()
            self.n, self.polls = n, 0

        def interrupted(self):
            self.polls += 1
            self.n -= 1
            return self.n < 0
    return FlipAfter()


def cancel_spills(torch, T, dev, fact, fg):
    """Fault 6 on the card at (ab)'s and (ac)'s full size: under
    FlipAfter(3) the spilling sort and the hybrid group-by raise
    ``Interrupted`` at their fourth poll, the second of their chunk loop
    (the sort after its first run spilled; the hybrid's sorter holds its
    first chunk's groups unspilled), and leave no file under their
    temporary prefix; the uninterrupted rerun equals the in-memory plan
    (``check_spill_sort``, ``check_hybrid``).  Returns the summary."""
    import tempfile

    from supersonic_tpu_torch.io import external
    from supersonic_tpu_torch.ops.sort import sort_working_set_bytes

    hd = hybrid_data(fact)
    h_t = T.Table.from_numpy(
        T.TupleSchema.of(("fk", T.INT32, False), ("v", T.FLOAT, False),
                         ("d", T.DOUBLE, False)), hd, device=dev)
    s_t = T.Table.from_numpy(
        T.TupleSchema.of(("g", T.INT32, False), ("fk", T.INT32, False),
                         ("v", T.FLOAT, False)),
        {k: v[:SPILL_ROWS] for k, v in fg.items()}, device=dev)
    limit = sort_working_set_bytes(s_t.schema, s_t.capacity, 2) // SPILL_RUNS
    quota = hybrid_quota(T, h_t, SPILL_ROWS // SPILL_RUNS)
    lines = []
    for label, make, check, spilled in (
            ("(ac) SortWithTempDirPrefix",
             lambda tmp: spill_sort_plan(T, s_t, limit, tmp),
             lambda out: check_spill_sort(torch, out, s_t), True),
            ("(ab) HybridGroupAggregate",
             lambda tmp: hybrid_plan(T, h_t, quota, tmp),
             lambda out: check_hybrid(out, T.execute(groupby_hi_plan(
                 T, h_t)), hd), False)):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_am_") as tmp:
            token = flip_after(T, 3)
            external.reset_disk_bytes()
            t0 = time.perf_counter()
            try:
                T.execute(make(tmp), cancel=token)
            except T.Interrupted:
                pass
            else:
                raise AssertionError(f"(am) {label}: not interrupted")
            stop_s = time.perf_counter() - t0
            written = external.disk_bytes["written"]
            left = list(pathlib.Path(tmp).rglob("*"))
            assert token.polls == 4, f"(am) {label}: {token.polls} polls"
            assert (written > 0) == spilled, f"(am) {label}: {written} bytes"
            assert not left, f"(am) {label}: files left behind: {left}"
            rows = check(T.execute(make(tmp)))
        lines.append(f"{label} {SPILL_ROWS} rows under FlipAfter(3): "
                     f"Interrupted at poll {token.polls} after "
                     f"{stop_s * 1e3:.1f} ms and {written} bytes spilled, "
                     f"no file left; the rerun's {rows} rows equal the "
                     f"in-memory plan's")
    return lines


def parity_phase(torch, T, dev, smi, total, fact, fg):
    """Path (am), from zeroed launch counters (added to ``total``): the
    seeded random plans on the card against the CPU, the JAX suite's
    sweep and capacity cases on the card, and fault 6's cancellation of
    the full-size spills.  Fails on any mismatch, and unless each of the
    five CUDA kernels ran.  Returns the summary."""
    from supersonic_tpu_torch import kernels

    start = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    plans, rows, bad, families, raises, sizes = fuzz_plans(T, dev)
    fuzz_s = time.perf_counter() - start
    log(f"(am) seeded random plans at {sizes} rows: {plans} plans "
        f"({', '.join(f'{k} {v}' for k, v in sorted(families.items()))}; "
        f"{raises} raise on the CPU), {rows} rows compared, {len(bad)} "
        f"mismatches, {fuzz_s:.1f} s on the host clock; card: {smi}")
    assert not bad, f"(am) first mismatch: {bad[0]}"
    t0 = time.perf_counter()
    cases = suite_edges(T, dev)
    log(f"(am) the JAX suite's sweep and capacity cases on the card: "
        f"{cases} cases pass, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for line in cancel_spills(torch, T, dev, fact, fg):
        log(f"(am) {line}; card: {smi}")
    log(f"(am) cancellation: {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    got = dict(kernels.launches)
    for k in got:
        total[k] += got[k]
    log(f"main path launches, (am): {got}")
    for k in AM_KERNELS:
        assert got[k] > 0, f"(am) did not launch {k}"
    log(f"(am): {time.perf_counter() - start:.1f} s on the host clock")
    return (f"(am) matches the CPU route: {plans} seeded plans, {rows} rows, "
            f"0 mismatches; {cases} sweep and capacity cases; both spills "
            f"interrupted under FlipAfter(3), no file left, reruns exact")


STAR_ROWS = 120_000_000       # path (an): SSB SF 20's lineorder capacity
STAR_YEARS, STAR_BRANDS = 7, 1000  # path (an): d_year x p_brand1 (Q2.1)
STAR_KEPT = 1_000_000         # path (an): sel below it keeps ~1M rows


def star_groupby_table(T, dev):
    """Path (an)'s fact, SSB Q2.1's group-by at SF 20: y INT32 1992-1998,
    b STRING of 1000 brands, rev INT32 and sel INT32 uniform over the rows,
    from default_rng(22).  Returns (table, host columns)."""
    rng = np.random.default_rng(22)
    n = STAR_ROWS
    cols = {"y": rng.integers(1992, 1992 + STAR_YEARS, n).astype(np.int32),
            "b": rng.integers(0, STAR_BRANDS, n).astype(np.int32),
            "rev": rng.integers(0, 10**7, n).astype(np.int32),
            "sel": rng.integers(0, n, n).astype(np.int32)}
    words = tuple(f"MFGR#{i:04d}" for i in range(STAR_BRANDS))
    schema = T.TupleSchema.of(("y", T.INT32, False), ("b", T.STRING, False),
                              ("rev", T.INT32, False),
                              ("sel", T.INT32, False))
    return T.Table.from_numpy(schema, cols, None,
                              {"b": T.Dictionary(words)}, device=dev), cols


def star_groupby_plan(T, t, kept):
    """Path (an): Sort(y, b) over GroupAggregate(y, b; SUM(rev) as INT64)
    over a fused Filter(sel < kept): the star's sort-path group-by (7000
    slots, past the dense domain) over a keep mask on 120M rows of
    capacity, the Sort dropping the re-rank."""
    agg = T.GroupAggregate(
        ["y", "b"], [T.AggSpec(T.Aggregation.SUM, "rev", "s",
                               output_type=T.INT64)],
        T.Filter(T.col("sel") < T.Const(kept, T.INT32), T.ScanTable(t)),
        T.GroupAggregateOptions(
            estimated_result_row_count=STAR_YEARS * STAR_BRANDS))
    return T.Sort([T.SortKey("y"), T.SortKey("b")], agg)


def check_star_groupby(out, cols, kept):
    """Path (an): the (y, b) groups of the kept rows in key order, each
    INT64 sum exact.  Returns the group count."""
    keep = cols["sel"] < kept
    slot = ((cols["y"][keep] - 1992).astype(np.int64) * STAR_BRANDS
            + cols["b"][keep])
    slots = STAR_YEARS * STAR_BRANDS
    counts = np.bincount(slot, minlength=slots)
    # exact: every partial sum is an integer below 2^53
    total = np.bincount(slot, weights=cols["rev"][keep],
                        minlength=slots).astype(np.int64)
    present = np.flatnonzero(counts)
    n = int(out.num_rows)
    assert n == present.shape[0], f"(an) kept {kept}: group count"
    got = {c: out.columns[c].values[:n].cpu().numpy() for c in ("y", "b", "s")}
    assert np.array_equal(got["y"], present // STAR_BRANDS + 1992), \
        f"(an) kept {kept}: y"
    assert np.array_equal(got["b"], present % STAR_BRANDS), \
        f"(an) kept {kept}: b"
    assert np.array_equal(got["s"], total[present]), f"(an) kept {kept}: sums"
    return n


def star_groupby_phase(torch, T, dev, smi):
    """Path (an): the star's group-by shape at 120M rows of capacity, kept
    by a mask that keeps ~1M rows, none, and every row: rows against
    numpy, then the median of 5 of the GroupAggregate node's device-stream
    ms (the CUDA events of its ``op.GroupAggregate.run`` span) and of the
    query on the host clock.  Returns the summary."""
    from supersonic_tpu_torch import tracing

    t, cols = star_groupby_table(T, dev)
    lines = []
    for kept in (STAR_KEPT, 0, STAR_ROWS):
        def plan():
            return star_groupby_plan(T, t, kept)

        groups = check_star_groupby(T.execute(plan()), cols, kept)
        node, wall = [], []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            tracing.clear()
            tracing.start()
            t0 = time.perf_counter()
            T.execute(plan())
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            tracing.stop()
            node += [s.device_ms for s in tracing.spans()
                     if s.name == "op.GroupAggregate.run"]
            tracing.clear()
        lines.append(
            f"(an) kept {int((cols['sel'] < kept).sum())} of {STAR_ROWS} "
            f"rows -> {groups} groups, exact: GroupAggregate node median "
            f"{statistics.median(node):.3f} ms (all: "
            f"{', '.join(f'{x:.3f}' for x in node)}), query median "
            f"{statistics.median(wall):.3f} ms; card: {smi}")
        log(lines[-1])
    del t
    torch.cuda.empty_cache()
    return "\n".join(lines)


def main():
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import supersonic_tpu_torch as T
    from supersonic_tpu_torch import kernels

    # 1. environment
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"device {name}; count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    kernels.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    # 3. kernels against their plain versions, at the main paths' shapes
    fact, dim = make_data()
    dfact, ddim, fk_half = dup8_data()
    fk = torch.from_numpy(fact["fk"]).to(dev)
    v = torch.from_numpy(fact["v"]).to(dev)
    dim_g = torch.from_numpy(dim["g"]).to(dev)
    keep = v > 0.5
    all_ids = dim_g[fk.long()]
    results = {
        "compaction": check_compaction(torch, fk, v, keep),
        "lut_gather": check_lut_gather(torch, fk, dim_g),
    }
    check_lut_gather_slice(torch, fk)
    results.update({
        "segment_reduce": check_segment_reduce(torch, all_ids, v, keep),
        "segment_reduce_64": check_segment_reduce_64(torch),
        "segment_reduce_small": check_segment_reduce_small(torch, all_ids, v),
        "spread": check_spread(torch, torch.from_numpy(dfact["v"]).to(dev)),
    })
    del fk, v, dim_g, keep, all_ids
    mruns = merge_data(torch, dev)
    results["merge_sorted"] = check_merge_sorted(torch, mruns)

    # 4. the main paths, each from zeroed launch counters
    fs, ds = schemas(T)
    fact_t = T.Table.from_numpy(fs, fact, device=dev)
    dim_t = T.Table.from_numpy(ds, dim, device=dev)
    perm = np.random.default_rng(7).permutation(DIM_ROWS)
    dim_p = {"pk": dim["pk"][perm], "g": dim["g"][perm]}
    dim_pt = T.Table.from_numpy(ds, dim_p, device=dev)
    half = {"pk": dim["pk"][:DIM_ROWS // 2], "g": dim["g"][:DIM_ROWS // 2]}
    dim_ht = T.Table.from_numpy(ds, half, device=dev)
    dfs, dds = dup8_schemas(T)
    dfact_t = T.Table.from_numpy(dfs, dfact, device=dev)
    dhalf_t = T.Table.from_numpy(dfs, dict(dfact, fk=fk_half), device=dev)
    ddim_t = T.Table.from_numpy(dds, ddim, device=dev)

    def pred():
        return T.col("v") > T.Const(0.5, T.FLOAT)

    total = {k: 0 for k in kernels.launches}

    def drive(label, plan, needs):
        """Execute ``plan`` from zeroed counters; every kernel in ``needs``
        must have launched."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = T.execute(plan)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        got = dict(kernels.launches)
        for k in got:
            total[k] += got[k]
        log(f"main path launches, {label}: {got}; first run "
            f"{first_ms:.1f} ms (host clock, bind included)")
        for k in needs:
            assert got[k] > 0, f"{label} did not launch {k}"
        return out

    out = drive("headline query", headline_plan(T, fact_t, dim_t),
                ("segment_reduce", "lut_gather"))
    assert kernels.launches["segment_reduce"] == 1, \
        "headline: segment_reduce must be one launch"
    groups = check_headline(out, fact, dim)
    filtered = drive("Filter", T.Filter(pred(), T.ScanTable(fact_t)),
                     ("compaction",))
    joined = drive("unmasked UNIQUE join", T.HashJoin(
        T.JoinType.INNER, ["fk"], ["pk"],
        T.Filter(pred(), T.ScanTable(fact_t)), T.ScanTable(dim_pt), T.KeyUniqueness.UNIQUE,
        lhs_projector=T.Projector.named("fk", "v"),
        rhs_projector=T.Projector.named("g")), ("compaction", "lut_gather"))
    keep_np = fact["v"] > 0.5
    n_keep = int(keep_np.sum())
    assert int(filtered.num_rows) == n_keep, "Filter: row count"
    for col in ("fk", "v"):
        want = torch.from_numpy(fact[col][keep_np]).to(dev)
        got = filtered.columns[col].values[:n_keep]
        assert torch.equal(bits(got), bits(want)), f"Filter: column {col}"
    inv = np.empty(DIM_ROWS, dtype=np.int64)
    inv[dim_p["pk"]] = np.arange(DIM_ROWS)
    assert int(joined.num_rows) == n_keep, "join: row count"
    want_g = dim_p["g"][inv[fact["fk"][keep_np]]]
    for col, want in (("fk", fact["fk"][keep_np]), ("v", fact["v"][keep_np]),
                      ("g", want_g)):
        got = joined.columns[col].values[:n_keep]
        assert torch.equal(bits(got), bits(torch.from_numpy(want).to(dev))), \
            f"join: column {col}"
    log(f"headline query: {groups} groups match numpy (counts exact, sums "
        f"rtol {SUM_RTOL}, sv non-increasing); Filter and permuted-pk join "
        f"match numpy ({n_keep} rows)")
    del out, filtered, joined

    out = drive("(a) dup8 INNER join", dup8_plan(
        T, dfact_t, ddim_t, T.JoinType.INNER, False),
        ("spread", "compaction", "lut_gather"))
    check_dup8_inner(torch, out, dfact, ddim)
    del out
    out = drive("(b) LEFT_OUTER NOT_UNIQUE join under Filter", dup8_plan(
        T, dhalf_t, ddim_t, T.JoinType.LEFT_OUTER, True),
        ("spread", "compaction", "lut_gather"))
    nb = check_dup8_left_outer(torch, out, dict(dfact, fk=fk_half), ddim)
    del out
    out = drive("(c) LEFT_OUTER UNIQUE join, row-id probe", T.HashJoin(
        T.JoinType.LEFT_OUTER, ["fk"], ["pk"], T.ScanTable(fact_t),
        T.ScanTable(dim_ht), T.KeyUniqueness.UNIQUE,
        lhs_projector=T.Projector.named("v"),
        rhs_projector=T.Projector.named("g")), ("lut_gather",))
    nulls = check_left_outer_unique(torch, out, fact, half)
    del out
    dup = dup_key_dim()
    dup_t = T.Table.from_numpy(
        T.TupleSchema.of(("pk", T.INT32, False), ("g", T.INT32, True)),
        {"pk": dup["pk"], "g": (dup["g"], dup["g_valid"])}, device=dev)
    want_f = dup_key_want(torch, fact, dup, dev)
    out = drive("(f) LEFT_OUTER UNIQUE join, duplicate rhs keys, fat LUT",
                dup_key_plan(T, fact_t, dup_t), ("lut_gather",))
    nulls_f = check_dup_key_join(torch, out, want_f)
    del out
    for run in range(4):  # the same rows, last wins, on every run
        check_dup_key_join(torch, T.execute(dup_key_plan(T, fact_t, dup_t)),
                           want_f)
    del want_f, dup_t
    log(f"joins match numpy in order: (a) {DUP_OUT} rows; (b) {nb[0]} rows, "
        f"{nb[1]} with a NULL w; (c) {FACT_ROWS} rows, {nulls} with a NULL g; "
        f"(f) {FACT_ROWS} rows, {nulls_f} with a NULL g, the last dim row of "
        f"each duplicate key, 5 runs")

    merge_t = merge_tables(T, mruns, dev)
    out = drive("(d) MergeUnionAll 2 x 50M", merge_plan(T, merge_t),
                ("merge_sorted",))
    n_d = check_merge_d(torch, out, mruns)
    del out
    m4 = merge4_data(torch, dev)
    m4_t = merge4_tables(T, m4, dev)
    out = drive("(e) 4-way MergeUnionAll", merge4_plan(T, m4_t),
                ("merge_sorted", "lut_gather"))
    n_e = check_merge_e(torch, out, m4)
    del out
    out = drive("UnionAll of (e)'s runs", T.UnionAll(
        *[T.ScanTable(t) for t in m4_t]), ("lut_gather",))
    check_union(torch, out, m4)
    del out, m4
    fold_steps_e(torch, kernels, m4_t)
    log(f"merges match numpy in order: (d) {n_d} rows; (e) {n_e[0]} rows, "
        f"{n_e[1]} with a NULL k, {n_e[2]} with a NaN d; the UnionAll of "
        f"(e)'s runs matches their concatenation")

    hi_t, hi_d = groupby_hi_tables(T, fact, dev)
    want_g = groupby_hi_want(fact["fk"], fact["v"], hi_d)
    few_t, few_g = groupby_few_table(T, fact, hi_d, dev)
    out = drive("(g) sort-path group-by 100M -> 1M keys",
                groupby_hi_plan(T, hi_t), ("compaction",))
    n_g = check_groupby_hi(torch, out, want_g)  # kept for (r) and (s1)
    again = T.execute(groupby_hi_plan(T, hi_t))
    assert same_bits(torch, out, again), "(g): a second run differs"
    del out, again
    out = drive("(j) sort-path group-by under a Filter, 64 INT64 keys",
                groupby_few_plan(T, few_t), ("compaction", "lut_gather"))
    n_j = check_groupby_few(out, few_g, fact["v"], hi_d)
    again = T.execute(groupby_few_plan(T, few_t))
    assert same_bits(torch, out, again), "(j): a second run differs"
    del out, again, few_g, hi_d
    str_t, codes = groupby_str_table(T, fact, dev)
    out = drive("(h) dense STRING-key group-by 100M -> 50 keys",
                groupby_str_plan(T, str_t), ("segment_reduce",))
    assert kernels.launches["segment_reduce"] == 1, \
        "(h): segment_reduce must be one launch"
    n_h = check_groupby_str(out, codes, fact["v"])
    concat_codes = codes[:CONCAT_ROWS].copy()  # the CONCAT path's words
    del out, codes
    log(f"group-bys match numpy: (g) {n_g} groups in first-occurrence "
        f"order, counts exact, sv rtol {SUM_RTOL}, sd within "
        f"{DOUBLE_RTOL} of its sum of |d|, mx bit for bit, a second run "
        f"bit for bit; (h) {n_h} words in order, counts exact, sv rtol "
        f"{SUM_RTOL}; (j) {n_j} keys "
        f"in first-occurrence order, counts exact, sd within {DOUBLE_RTOL} "
        f"of its sum of |d|, sv rtol {SUM_RTOL}, a second run bit for bit")

    out = drive("(k) merge-probe INNER UNIQUE join",
                merge_probe_plan(T, fact_t, dim_t),
                ("compaction", "lut_gather"))
    check_merge_probe(torch, out, fact, dim)
    del out
    sp_fact_t, sp_dim_t = sparse64_tables(T, dfact, ddim, dev)
    out = drive("(l) sparse INT64 NOT_UNIQUE join, merge probe",
                sparse64_plan(T, sp_fact_t, sp_dim_t),
                ("compaction", "spread", "lut_gather"))
    check_dup8_inner(torch, out, dfact, ddim)
    del out
    str_fact_t, str_dim_t, w_of = join_str_tables(T, fact, dev)
    out = drive("(m) STRING-key INNER UNIQUE join",
                join_str_plan(T, str_fact_t, str_dim_t),
                ("compaction", "lut_gather"))
    n_m = check_join_str(torch, out, fact, w_of)
    del out, w_of
    right_cap, full_cap = outer_rows(fk_half, ddim["pk"])
    out = drive("(n) RIGHT_OUTER NOT_UNIQUE join", outer_plan(
        T, dhalf_t, ddim_t, T.JoinType.RIGHT_OUTER, right_cap),
        ("compaction", "spread", "lut_gather"))
    n_r = check_right_outer(torch, out, fk_half, dfact["v"], ddim)
    del out
    out = drive("(n) FULL_OUTER NOT_UNIQUE join", outer_plan(
        T, dhalf_t, ddim_t, T.JoinType.FULL_OUTER, full_cap),
        ("compaction", "spread", "lut_gather"))
    n_f = check_full_outer(torch, out, fk_half, dfact["v"], ddim)
    del out
    log(f"joins (k)-(n) match numpy: (k) {FACT_ROWS} rows in order; (l) "
        f"{DUP_OUT} rows in order; (m) {n_m} rows in order "
        f"({FACT_ROWS - n_m} probe rows without a build row); (n) "
        f"RIGHT_OUTER {n_r[0]} rows in (dim row, fact order), {n_r[1]} dim "
        f"rows without a fact row; FULL_OUTER {n_f[0]} rows as a multiset, "
        f"{n_f[1]} NULL-padded dim rows")

    # (o)-(t) and CONCAT: the scalar, DISTINCT, cluster, clamped and quota
    # aggregates, Limit and friends, the row-id joins
    from supersonic_tpu_torch.ops import host
    li = lineitem_data()
    li_t = lineitem_table(T, li, dev)
    out = drive("(o) Q6 ScalarAggregate", q6_plan(T, li_t), ("compaction",))
    n_o = check_q6(out, li)
    fg_t, fg = fact_g_table(T, fact, dim, dev)
    out = drive("(o) scalar DISTINCT", scalar_distinct_plan(T, fg_t), ())
    check_scalar_distinct(out, fg)
    out = drive("(o) Q6 keeping nothing", q6_plan(T, li_t, hi=Q6_LO),
                ("compaction",))
    assert out.to_pylist() == [(None, 0)], "(o): an empty filter"
    out = drive("(p) COUNT(DISTINCT) group-by",
                distinct_groupby_plan(T, fg_t), ("compaction", "lut_gather"))
    n_p = check_distinct_groupby(out, fg)
    again = T.execute(distinct_groupby_plan(T, fg_t))
    assert same_bits(torch, out, again), "(p): a second run differs"
    del out, again
    out = drive("(q1) AggregateClusters over merge (d)",
                clusters_merge_plan(T, merge_t),
                ("merge_sorted", "compaction", "lut_gather"))
    n_q1 = check_clusters_merge(out, mruns)
    cl_t = clusters_raw_table(T, fact["v"], dev)
    out = drive("(q2) AggregateClusters in raw order",
                clusters_raw_plan(T, cl_t), ("compaction", "lut_gather"))
    n_q2 = check_clusters_raw(out, fact["v"])
    out = drive("(r1) max_unique_keys_in_result", clamp_plan(T, hi_t),
                ("compaction", "lut_gather"))
    check_clamp(out, want_g)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = drive("(r2) best-effort memory quota",
                    quota_plan(T, hi_t, "BestEffortGroupAggregate"),
                    ("compaction", "lut_gather"))
    assert any("best-effort group-by exceeded memory_quota" in str(w.message)
               for w in seen), "(r2): no warning"
    n_r2 = check_best_effort(out, fact["fk"], want_g)
    del out
    for cls, enforce in (("GroupAggregate", False),
                         ("BestEffortGroupAggregate", True)):
        try:
            T.execute(quota_plan(T, hi_t, cls, enforce))
        except T.EvaluationError as e:
            assert "aggregate result overflow" in str(e), str(e)
        else:
            raise AssertionError(f"(r3): {cls} under a strict quota did not "
                                 "raise")
    out = drive("(s1) top 10 of (g)", topn_plan(T, hi_t),
                ("compaction", "lut_gather"))
    check_topn(out, want_g)
    del want_g
    out = drive("(s2) Limit(25M, 50M)", T.Limit(
        LIMIT_OFFSET, LIMIT_ROWS, T.ScanTable(fact_t)), ("lut_gather",))
    check_slices(torch, out, fact_t, LIMIT_OFFSET, LIMIT_ROWS)
    out = drive("(s3) Coalesce", coalesce_plan(T, fact_t), ())
    check_coalesce(torch, out, fact_t)
    out = drive("(s4) Generate + Sequence", generate_plan(T, FACT_ROWS, dev),
                ())
    assert torch.equal(out.columns["q"].values,
                       torch.arange(FACT_ROWS, device=dev)), "(s4)"
    out = drive("(t1) RowidMergeJoin", rowid_plan(T, fact_t, dim_t),
                ("lut_gather",))
    check_rowid(torch, out, fact, dim, dev)
    del out
    fk_bad = fact_t.columns["fk"].values.clone()
    fk_bad[FACT_ROWS // 3] = DIM_ROWS  # one fk past the dim's rows
    bad_t = T.Table(fact_t.schema, dict(fact_t.columns, fk=T.Column(
        fk_bad, None)), FACT_ROWS, dev)
    try:
        T.execute(rowid_plan(T, bad_t, dim_t))
    except T.EvaluationError as e:
        assert "rowid join referential integrity" in str(e), str(e)
    else:
        raise AssertionError("(t1): an fk out of range did not raise")
    del fk_bad, bad_t
    ff_t, key_t, sorted_fact = foreign_tables(torch, T, fact, dev)
    out = drive("(t2) ForeignFilter", foreign_plan(T, ff_t, key_t),
                ("compaction",))
    n_t2 = check_foreign(torch, out, sorted_fact, dev)
    del out, sorted_fact
    cc_t, cc = concat_table(T, fact, dim, concat_codes, dev)
    out = drive("CONCAT group-by", concat_plan(T, cc_t), ("compaction",))
    n_cc = check_concat(out, cc)
    del out
    log(f"(o)-(t) match numpy: (o) Q6 {n_o} rows kept, count exact, revenue "
        f"within {DOUBLE_RTOL} of its sum of |rev|; the scalar DISTINCT "
        f"exact; a Filter keeping nothing gives (None, 0); (p) {n_p} groups, "
        f"COUNT(DISTINCT fk) and counts exact, a second run bit for bit; "
        f"(q1) {n_q1} clusters of merge (d); (q2) {n_q2} clusters in raw "
        f"order; (r1) {CLAMP_KEYS} groups, the last holding every later "
        f"one; (r2) {n_r2} rows, the first {QUOTA_ROWS} keys once each, "
        f"re-aggregated to (g)'s result, with the warning; (r3) the strict "
        f"and enforced quotas raise; (s1) the top 10; (s2) {LIMIT_ROWS} "
        f"rows; (s3) Coalesce; (s4) Generate; (t1) every row and the "
        f"integrity flag; (t2) {n_t2} rows; CONCAT {n_cc} groups byte for "
        f"byte, route {host.concat_route}")

    # (u)-(z): the expression engine and its types
    slice_medians, slice_summary = slice_phases(T, dev, drive, li, li_t,
                                                fact, fg_t, fg)
    log(slice_summary)

    # (aa)-(ac): the columnar files, the spilling group-by and sort
    log(spill_phases(torch, T, dev, drive, smi, fact, fact_t, str_dim_t, fg))

    # (ad)-(ag): the harness, the twins of bench.py and __graft_entry__.py,
    # distribution at world size 1
    log(tooling_phases(torch, T, dev, smi, total, fact, dim, fact_t, dim_t))

    # (ah)-(al): the twins of bench_ops.py, scripts/bench_configs.py,
    # scripts/stress_edges.py, examples/operation_example.py, bench_dist.py
    log(twin_phases(torch, T, dev, smi, total))

    # (am): the card's route against the CPU route
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    log(parity_phase(torch, T, dev, smi, total, fact, fg))

    # (an): the star's sort-path group-by over a keep mask
    log(star_groupby_phase(torch, T, dev, smi))

    # 5. times, host clock around execute (which ends in a sync)
    def median_ms(plan_fn, label, size):
        times = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T.execute(plan_fn())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"{label} {size}: median {statistics.median(times):.3f} ms over "
            f"{REPEATS} runs (all: {', '.join(f'{t:.3f}' for t in times)}); "
            f"card: {smi}")

    median_ms(lambda: headline_plan(T, fact_t, dim_t), "headline query",
              f"{FACT_ROWS} x {DIM_ROWS}")
    median_ms(lambda: dup8_plan(T, dfact_t, ddim_t, T.JoinType.INNER, False),
              "(a) dup8 INNER join", f"{DUP_FACT_ROWS} x {DUP_DIM_ROWS} -> "
              f"{DUP_OUT} rows")
    median_ms(lambda: merge_plan(T, merge_t), "(d) MergeUnionAll",
              f"2 x {MERGE_RUN_ROWS} -> {2 * MERGE_RUN_ROWS} rows")
    median_ms(lambda: merge4_plan(T, m4_t), "(e) 4-way MergeUnionAll",
              f"4 x {MERGE4_RUN_ROWS} -> {4 * MERGE4_RUN_ROWS} rows")
    median_ms(lambda: groupby_hi_plan(T, hi_t), "(g) sort-path group-by",
              f"{FACT_ROWS} -> {HI_KEYS} keys")
    median_ms(lambda: groupby_str_plan(T, str_t),
              "(h) dense STRING-key group-by",
              f"{FACT_ROWS} -> {len(WORDS)} keys")
    median_ms(lambda: groupby_few_plan(T, few_t),
              "(j) sort-path group-by under a Filter",
              f"{FACT_ROWS} -> {FEW_GROUPS} INT64 keys")
    median_ms(lambda: merge_probe_plan(T, fact_t, dim_t),
              "(k) merge-probe join", f"{FACT_ROWS} x {DIM_ROWS}")
    median_ms(lambda: sparse64_plan(T, sp_fact_t, sp_dim_t),
              "(l) sparse INT64 NOT_UNIQUE join",
              f"{DUP_FACT_ROWS} x {DUP_DIM_ROWS} -> {DUP_OUT} rows")
    median_ms(lambda: join_str_plan(T, str_fact_t, str_dim_t),
              "(m) STRING-key join", f"{FACT_ROWS} x {DIM_ROWS}")
    median_ms(lambda: outer_plan(T, dhalf_t, ddim_t, T.JoinType.RIGHT_OUTER,
                                 right_cap),
              "(n) RIGHT_OUTER join", f"{DUP_FACT_ROWS} x {DUP_DIM_ROWS} -> "
              f"{right_cap} rows")
    median_ms(lambda: outer_plan(T, dhalf_t, ddim_t, T.JoinType.FULL_OUTER,
                                 full_cap),
              "(n) FULL_OUTER join", f"{DUP_FACT_ROWS} x {DUP_DIM_ROWS} -> "
              f"{full_cap} rows")
    median_ms(lambda: q6_plan(T, li_t), "(o) Q6 ScalarAggregate",
              f"{FACT_ROWS} rows")
    median_ms(lambda: scalar_distinct_plan(T, fg_t), "(o) scalar DISTINCT",
              f"{FACT_ROWS} rows")
    median_ms(lambda: distinct_groupby_plan(T, fg_t),
              "(p) COUNT(DISTINCT) group-by", f"{FACT_ROWS} -> {GROUPS} keys")
    median_ms(lambda: clusters_merge_plan(T, merge_t),
              "(q1) AggregateClusters over merge (d)",
              f"2 x {MERGE_RUN_ROWS} -> {GROUPS} clusters")
    median_ms(lambda: clusters_raw_plan(T, cl_t),
              "(q2) AggregateClusters in raw order",
              f"{FACT_ROWS} -> {FACT_ROWS // CLUSTER_ROWS} clusters")
    median_ms(lambda: clamp_plan(T, hi_t), "(r1) max_unique_keys_in_result",
              f"{FACT_ROWS} -> {CLAMP_KEYS} of {HI_KEYS} keys")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        median_ms(lambda: quota_plan(T, hi_t, "BestEffortGroupAggregate"),
                  "(r2) best-effort memory quota",
                  f"{FACT_ROWS} -> {n_r2} rows")
    median_ms(lambda: topn_plan(T, hi_t), "(s1) top 10 of (g)",
              f"{FACT_ROWS} -> 10 rows")
    median_ms(lambda: T.Limit(LIMIT_OFFSET, LIMIT_ROWS, T.ScanTable(fact_t)),
              "(s2) Limit", f"{LIMIT_ROWS} of {FACT_ROWS} rows")
    median_ms(lambda: rowid_plan(T, fact_t, dim_t), "(t1) RowidMergeJoin",
              f"{FACT_ROWS} x {DIM_ROWS}")
    median_ms(lambda: foreign_plan(T, ff_t, key_t), "(t2) ForeignFilter",
              f"{FACT_ROWS} x {DIM_ROWS // 2} -> {n_t2} rows")
    median_ms(lambda: concat_plan(T, cc_t),
              f"CONCAT group-by (route {host.concat_route})",
              f"{CONCAT_ROWS} -> {GROUPS} groups")
    for plan_fn, label, size in slice_medians:
        T.set_local_timezone(LOCAL_ZONE if "Local" in label else None)
        median_ms(plan_fn, label, size)
    T.set_local_timezone(None)

    meta = {
        "compaction": ("supersonic_tpu_torch/csrc/compaction.cu",
                       "supersonic_tpu/kernels/compaction.py:314"),
        "lut_gather": ("supersonic_tpu_torch/csrc/lut_gather.cu",
                       "supersonic_tpu/kernels/lut_gather.py:111"),
        "segment_reduce": ("supersonic_tpu_torch/csrc/segment_reduce.cu",
                           "supersonic_tpu/kernels/segment_reduce.py:336"),
        "segment_reduce_small": (
            "supersonic_tpu_torch/csrc/segment_reduce.cu",
            "supersonic_tpu/kernels/segment_reduce.py:103"),
        "spread": ("supersonic_tpu_torch/csrc/spread.cu",
                   "supersonic_tpu/kernels/spread.py:333"),
        "merge_sorted": ("supersonic_tpu_torch/csrc/merge_sorted.cu",
                         "supersonic_tpu/kernels/merge_sorted.py:272"),
    }
    log(f"smoke: {time.perf_counter() - start:.1f} s on the host clock, "
        f"build included")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": meta[k][0],
         "replaces": meta[k][1], "launches": total[k], **results[k]}
        for k in meta]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
