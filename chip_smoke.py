#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (supersonic_tpu_torch).

Drives the port's main paths on one CUDA card at real size: the headline
query (BASELINE.json configs 4/5: FK build 1M x probe 100M, 64 groups)
under both of its bindings, the multi-match join of bench_ops.py:188-206
("join NOT_UNIQUE dup8") scaled to emit 100M rows (dim 1M rows, 8 per
key; fact 12.5M rows), the sorted merge of bench_ops.py:281-299
("merge_union 2x4M") scaled to 2 x 50M rows, and bench_ops.py's two
group-bys ("groupby 8M->1M keys", "groupby_str 8M->50") and a DOUBLE
SUM into 64 groups (TPC-H Q1's shape) at 100M rows:

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
     sort path over a compacted order, twice, bit for bit); (h)
     bench_ops.py:234-238's "groupby_str
     8M->50" at 100M rows (dense by the dictionary, one segment-reduce
     launch); (i) the headline through the aggregate pushdown binding,
     under its Sort and in insertion order, row for row against the
     direct binding.  Each is checked against numpy.  Then (e)'s three
     fold steps, each timed with its bound and its launches
  5. the median times of the headline query (under both bindings, and
     its aggregate in insertion order under both), of join (a), of merges
     (d) and (e) and of group-bys (g), (h) and (j)

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
              ("(b) lhs rows that emit", DUP_FACT_ROWS, 4, 0.5)]
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
    log(f"kernel lut_gather: bit-exact on 10 cases (n={n}, K={K}; "
        f"specialised: one, two and three 4-byte lanes, with a 1-byte flag, "
        f"an odd-offset slice; generic: 8-byte lanes, 32 lanes; staged); "
        f"{t}")
    return {"max_abs_err": err, **t}


def seg_compare(torch, name, got, want, reqs, rtol=SUM_RTOL):
    """Kernel and plain outputs of segment-reduce requests ((values, mode)
    or (values, valid, mode)): f32 sums within ``rtol`` (another order of
    adds), everything else bit for bit; NaN slots by isnan.  Returns the
    largest |difference| over the slots that hold no NaN."""
    err = 0.0
    for r, a, b in zip(reqs, got, want):
        mode, values = r[-1], r[0]
        assert a.dtype == b.dtype and a.shape == b.shape, (name, mode)
        if a.dtype == torch.float32:
            na, nb = a.isnan(), b.isnan()
            assert torch.equal(na, nb), f"{name} {mode}: NaN slots differ"
            a, b = a[~na], b[~nb]
        if mode == "sum" and values is not None and \
                values.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=rtol, atol=0,
                                       msg=f"{name} f32 sum")
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
    dense kernel), whose sorted order the compaction kernel cuts to the
    kept rows, and whose runs are 780k rows each."""
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


def pushdown_plans(T, fact_t, dim_t):
    """Path (i): the headline plan, and its aggregate alone (insertion
    order), each (pushdown binding, direct binding): the aggregate's
    ``_pushdown_disabled`` set either way."""
    plans = []
    for sort in (True, False):
        pair = []
        for disabled in (False, True):
            p = headline_plan(T, fact_t, dim_t)
            agg = p.child
            agg._pushdown_disabled = disabled
            pair.append(p if sort else agg)
        plans.append(pair)
    return plans


def check_pushdown(out, direct, ordered):
    """Path (i): the pushdown binding's rows equal the direct binding's:
    keys and counts exact, sums within rtol 1e-4; in order without the
    Sort, by key under it (sums that differ in their last bits may swap
    two near-equal groups there)."""
    got, want = out.to_pylist(), direct.to_pylist()
    assert [a.name for a in out.schema] == [a.name for a in direct.schema]
    assert [a.type for a in out.schema] == [a.type for a in direct.schema]
    if not ordered:
        got, want = sorted(got), sorted(want)
        svs = [r[1] for r in out.to_pylist()]
        assert all(a >= b for a, b in zip(svs, svs[1:])), "(i): sv order"
    assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in want], \
        "(i): keys, counts or their order"
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=SUM_RTOL)
    return len(got)


def main():
    import torch

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
        "segment_reduce": check_segment_reduce(torch, all_ids, v, keep),
        "segment_reduce_small": check_segment_reduce_small(torch, all_ids, v),
        "spread": check_spread(torch, torch.from_numpy(dfact["v"]).to(dev)),
    }
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
        out = T.execute(plan)
        torch.cuda.synchronize()
        got = dict(kernels.launches)
        for k in got:
            total[k] += got[k]
        log(f"main path launches, {label}: {got}")
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
    n_g = check_groupby_hi(torch, out, want_g)
    del want_g
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
    del out, codes
    n_i = []
    for ordered, (pushed, direct) in zip(
            (False, True), pushdown_plans(T, fact_t, dim_t)):
        label = ("(i) headline aggregate, pushdown binding" if ordered
                 else "(i) headline query, pushdown binding")
        out = drive(label, pushed, ("compaction", "lut_gather"))
        n_i.append(check_pushdown(out, T.execute(direct), ordered))
        del out
    log(f"group-bys match numpy: (g) {n_g} groups in first-occurrence "
        f"order, counts exact, sv rtol {SUM_RTOL}, sd within "
        f"{DOUBLE_RTOL} of its sum of |d|, mx bit for bit, a second run "
        f"bit for bit; (h) {n_h} words in order, counts exact, sv rtol "
        f"{SUM_RTOL}; (i) the pushdown binding's {n_i[0]} sorted and "
        f"{n_i[1]} ordered rows equal the direct binding's; (j) {n_j} keys "
        f"in first-occurrence order, counts exact, sd within {DOUBLE_RTOL} "
        f"of its sum of |d|, sv rtol {SUM_RTOL}, a second run bit for bit")

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
    for i, label in enumerate(("(i) headline query", "(i) headline aggregate "
                               "in insertion order")):
        for j, binding in enumerate(("pushdown", "direct")):
            median_ms(lambda: pushdown_plans(T, fact_t, dim_t)[i][j],
                      f"{label}, {binding} binding",
                      f"{FACT_ROWS} x {DIM_ROWS}")

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
