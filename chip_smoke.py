#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (supersonic_tpu_torch).

Drives the port's main path once on one CUDA card, at the headline query's
real size (BASELINE.json configs 4/5: FK build 1M x probe 100M, 64 groups):

  1. environment: torch version, the card, nvidia-smi's name and power limit
  2. build: compiles the CUDA kernels from csrc/ (timed)
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: compaction and LUT gather bit for bit (ragged
     tail, out_cap below the kept count, out-of-range indices), the
     integer segment-reduce modes exactly, f32 sums within rtol 1e-4
  4. the main path, once, with every launch counter at 0 before it: the
     headline plan of bench.py:73-86 through ``execute``, then Filter on
     its own and an unmasked UNIQUE join over a permuted primary key (the
     two operators that compact); each is checked against numpy
  5. the query's median time

It prints one JSON line of per-kernel results, then as its last line
``{"ok": true, "device": {...}}``.  It exits non-zero, and prints no
result, when any phase fails or no CUDA device is present.  It takes no
arguments: the size is always the one above.

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


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps=10):
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    from supersonic_tpu_torch.kernels.compaction import (compact_arrays_ref,
                                                         compact_kernel)

    n = keep.shape[0]
    kept = int(keep.sum())
    cases = [("main", [fk, v], n), ("out_cap<kept", [fk, v], kept // 2)]
    # every payload width moves natively (1, 4 and 8 bytes)
    m = 1_000_003  # ragged: not a multiple of the 1024-row block
    g = torch.Generator(device="cuda").manual_seed(7)
    mask = torch.rand(m, device="cuda", generator=g) < 0.37
    wide = [torch.randn(m, device="cuda", dtype=torch.float64, generator=g),
            torch.randint(-2**62, 2**62, (m,), device="cuda", generator=g),
            torch.rand(m, device="cuda", generator=g) < 0.5,
            torch.randn(m, device="cuda", generator=g)]
    cases.append(("widths", wide, m))
    err = 0.0
    for name, pays, cap in cases:
        msk = keep if name != "widths" else mask
        got, cnt = compact_kernel(pays, msk, cap)
        want, wcnt = compact_arrays_ref(pays, msk, cap)
        c = int(cnt)
        assert c == int(wcnt), (name, c, int(wcnt))
        for a, b in zip(got, want):
            assert torch.equal(bits(a[:c]), bits(b[:c])), f"compaction {name}"
            err = max(err, max_abs_diff(a[:c], b[:c]))
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: compact_kernel([fk, v], keep, n))
    plain = cuda_ms(torch, lambda: compact_arrays_ref([fk, v], keep, n))
    log(f"kernel compaction: bit-exact on {len(cases)} cases "
        f"(n={n}, kept={kept}); {ms:.3f} ms vs plain {plain:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain}


def check_lut_gather(torch, fk, dim_g):
    from supersonic_tpu_torch.kernels.lut_gather import (lut_gather,
                                                         lut_gather_ref,
                                                         staged)

    K = dim_g.shape[0]
    idx = fk.clone()
    idx[:1000] = -5          # out of range below
    idx[1000:2000] = K + 7   # out of range above
    flag = torch.ones(K, dtype=torch.bool, device="cuda")
    small_k = 2048
    small = [torch.arange(small_k, dtype=torch.int32, device="cuda") * 3,
             torch.linspace(-1, 1, small_k, device="cuda"),
             torch.arange(small_k, device="cuda") % 3 == 0,
             torch.arange(small_k, device="cuda", dtype=torch.float64) / 7]
    sidx = (fk % (small_k + 64) - 32).to(torch.int32)
    cases = [("row-id probe", [dim_g], idx, K),
             ("fat-LUT probe", [dim_g, flag], idx, K),
             ("staged", small, sidx, small_k)]
    err = 0.0
    for name, luts, ix, k in cases:
        got = lut_gather(luts, ix, k)
        want = lut_gather_ref(luts, ix, k)
        for a, b in zip(got, want):
            assert torch.equal(bits(a), bits(b)), f"lut_gather {name}"
            err = max(err, max_abs_diff(a, b))
    assert not staged([dim_g], K) and staged(small, small_k)
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: lut_gather([dim_g], fk, K))
    plain = cuda_ms(torch, lambda: lut_gather_ref([dim_g], fk, K))
    log(f"kernel lut_gather: bit-exact on {len(cases)} cases (n={fk.shape[0]}"
        f", K={K}); {ms:.3f} ms vs plain {plain:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain}


def check_segment_reduce(torch, ids, v):
    from supersonic_tpu_torch.kernels.segment_reduce import (
        segment_reduce_multi, segment_reduce_multi_ref)

    n = ids.shape[0]
    live = (ids >= 0).to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    iv = (v * 1000).to(torch.int32) - 500
    headline = [(live, "count"), (v, "sum")]
    every = headline + [(iv, "sum"), (iv, "min"), (iv, "max"),
                        (v, "min"), (v, "max"), (pos, "firstpos")]
    err = 0.0
    for K, reqs in ((GROUPS, every), (300, every)):
        seg = ids if K == GROUPS else torch.where(
            ids >= 0, (pos % 310) - 5, -1).to(torch.int32)
        got = segment_reduce_multi(reqs, seg, K)
        want = segment_reduce_multi_ref(reqs, seg, K)
        ref64 = torch.zeros(K, dtype=torch.float64, device="cuda")
        ok = (seg >= 0) & (seg < K)
        ref64.index_add_(0, seg[ok].long(), v[ok].double())
        for (vals, mode), a, b in zip(reqs, got, want):
            if mode == "sum" and vals.dtype == torch.float32:
                torch.testing.assert_close(a.double(), ref64, rtol=SUM_RTOL,
                                           atol=0)
                torch.testing.assert_close(a, b, rtol=SUM_RTOL, atol=0)
            else:
                assert torch.equal(bits(a), bits(b)), f"segment_reduce {mode}"
            err = max(err, max_abs_diff(a, b))
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: segment_reduce_multi(headline, ids, GROUPS))
    plain = cuda_ms(torch,
                    lambda: segment_reduce_multi_ref(headline, ids, GROUPS))
    log(f"kernel segment_reduce: integer modes exact, f32 sums within "
        f"rtol {SUM_RTOL} (K={GROUPS} and 300, n={n}, max abs diff "
        f"{err:.6g}); {ms:.3f} ms vs plain {plain:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain}


def check_headline(out, fact, dim):
    """Rows of the headline query against a float64 numpy computation
    (bench.py:42-52).  Groups and counts match exactly.  Sums match within
    rtol 1e-4: the port accumulates in f32 (SUM keeps the input type, as
    the reference does), about 780k rows per group at 100M rows, in an
    order set by the kernel's atomics."""
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

    # 3. kernels against their plain versions, at the main path's shapes
    fact, dim = make_data()
    fk = torch.from_numpy(fact["fk"]).to(dev)
    v = torch.from_numpy(fact["v"]).to(dev)
    dim_g = torch.from_numpy(dim["g"]).to(dev)
    keep = v > 0.5
    ids = torch.where(keep, dim_g[fk.long()], -1).to(torch.int32)
    results = {
        "compaction": check_compaction(torch, fk, v, keep),
        "lut_gather": check_lut_gather(torch, fk, dim_g),
        "segment_reduce": check_segment_reduce(torch, ids, v),
    }
    del fk, v, dim_g, keep, ids

    # 4. the main path once, from zeroed launch counters
    fs, ds = schemas(T)
    fact_t = T.Table.from_numpy(fs, fact, None, dev)
    dim_t = T.Table.from_numpy(ds, dim, None, dev)
    perm = np.random.default_rng(7).permutation(DIM_ROWS)
    dim_p = {"pk": dim["pk"][perm], "g": dim["g"][perm]}
    dim_pt = T.Table.from_numpy(ds, dim_p, None, dev)

    def pred():
        return T.col("v") > T.Const(0.5, T.FLOAT)

    filter_plan = T.Filter(pred(), T.ScanTable(fact_t))
    join_plan = T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"],
                           T.Filter(pred(), T.ScanTable(fact_t)),
                           T.ScanTable(dim_pt), T.KeyUniqueness.UNIQUE,
                           lhs_projector=T.Projector.named("fk", "v"),
                           rhs_projector=T.Projector.named("g"))
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = T.execute(headline_plan(T, fact_t, dim_t))
    torch.cuda.synchronize()
    by_query = dict(kernels.launches)
    filtered = T.execute(filter_plan)
    joined = T.execute(join_plan)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    by_compacting = {k: counts[k] - by_query[k] for k in counts}
    log(f"main path launches: headline query {by_query}; Filter and "
        f"unmasked join {by_compacting}")
    for k in ("segment_reduce", "lut_gather"):
        assert by_query[k] > 0, f"headline query did not launch {k}"
    for k in ("compaction", "lut_gather"):
        assert by_compacting[k] > 0, f"Filter/join did not launch {k}"

    groups = check_headline(out, fact, dim)
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

    # 5. the query's time, host clock around execute (which ends in a sync)
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.execute(headline_plan(T, fact_t, dim_t))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"headline query {FACT_ROWS} x {DIM_ROWS}: median "
        f"{statistics.median(times):.3f} ms over {REPEATS} runs "
        f"(all: {', '.join(f'{t:.3f}' for t in times)}); card: {smi}")

    meta = {
        "compaction": ("supersonic_tpu_torch/csrc/compaction.cu",
                       "supersonic_tpu/kernels/compaction.py:314"),
        "lut_gather": ("supersonic_tpu_torch/csrc/lut_gather.cu",
                       "supersonic_tpu/kernels/lut_gather.py:111"),
        "segment_reduce": ("supersonic_tpu_torch/csrc/segment_reduce.cu",
                           "supersonic_tpu/kernels/segment_reduce.py:336"),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": meta[k][0],
         "replaces": meta[k][1], "launches": counts[k], **results[k]}
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
