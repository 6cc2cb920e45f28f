#!/usr/bin/env python3
"""Device time of the compaction and spread calls of chip_smoke.py's main
paths, each at the shape and with the very tensors its caller gives it, on
one CUDA card.

The script builds chip_smoke.py's tables (100M fact x 1M dim rows; the
dup8 tables, 12.5M fact x 1M dim rows) and executes four plans once each,
recording every ``compact_kernel`` and ``spread_kernel`` call the operators
make: the unfused Filter (v > 0.5), the unmasked UNIQUE join over a
permuted pk, join (a) (dup8 INNER, 100M rows) and join (b) (LEFT_OUTER
NOT_UNIQUE under Filter).  Then, for each checkout named by ``--roots`` in
turn (default: this one), it times every recorded call with that
checkout's wrappers on the recorded inputs: the CUDA-event median over 10
windows of 5 back-to-back calls, and a torch.profiler split of 5 calls into
device time per kernel (every CUDA kernel and memset row, by name, per
call), beside the byte bound (each input read once, each output written
once, over 3.35 TB/s; spread reads only its live sources).  It checks that
every checkout's outputs equal the first one's bit for bit.  One JSON line
per checkout and call.

``--roots P C C P`` compares the checkouts of two commits in one process,
in turns, on the same inputs (their wrappers must take the arguments these
do).  ``--calls`` picks calls by label (Filter, join, a, b; with
``compaction`` or ``spread``, e.g. ``a:spread``).

    python3 scripts/measure_torch_compaction_spread.py [--roots DIR ...]
        [--calls LABEL ...]
"""
import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HERE = pathlib.Path(__file__).resolve().parent.parent
REPS = 5
I32_MAX = 2 ** 31 - 1
PKG = "supersonic_tpu_torch"


def profile_split(fn):
    """Device ms per call of every kernel (and memset) row of fn()."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            out[e.key[:80]] = e.self_device_time_total / REPS / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def wrappers(root):
    """(compact_kernel, spread_kernel) of the package under ``root``."""
    for name in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    try:
        from supersonic_tpu_torch.kernels import compaction, spread
        return compaction.compact_kernel, spread.spread_kernel
    finally:
        sys.path.pop(0)


def record(smoke, calls):
    """Executes the four plans with this checkout's operators and returns
    [(name, kind, args)] of their compaction and spread calls."""
    sys.path.insert(0, str(HERE))
    import supersonic_tpu_torch as T
    from supersonic_tpu_torch.kernels import compaction as C
    from supersonic_tpu_torch.ops import hash_join as HJ

    dev = torch.device("cuda", 0)
    fact, dim = smoke.make_data()
    fs, ds = smoke.schemas(T)
    fact_t = T.Table.from_numpy(fs, fact, device=dev)
    perm = np.random.default_rng(7).permutation(smoke.DIM_ROWS)
    dim_pt = T.Table.from_numpy(ds, {"pk": dim["pk"][perm],
                                     "g": dim["g"][perm]}, device=dev)
    dfact, ddim, fk_half = smoke.dup8_data()
    dfs, dds = smoke.dup8_schemas(T)
    dfact_t = T.Table.from_numpy(dfs, dfact, device=dev)
    dhalf_t = T.Table.from_numpy(dfs, dict(dfact, fk=fk_half), device=dev)
    ddim_t = T.Table.from_numpy(dds, ddim, device=dev)

    def pred():
        return T.col("v") > T.Const(0.5, T.FLOAT)

    plans = [
        ("Filter", lambda: T.Filter(pred(), T.ScanTable(fact_t))),
        ("join", lambda: T.HashJoin(
            T.JoinType.INNER, ["fk"], ["pk"],
            T.Filter(pred(), T.ScanTable(fact_t)), T.ScanTable(dim_pt),
            T.KeyUniqueness.UNIQUE, lhs_projector=T.Projector.named("fk", "v"),
            rhs_projector=T.Projector.named("g"))),
        ("a", lambda: smoke.dup8_plan(T, dfact_t, ddim_t, T.JoinType.INNER,
                                      False)),
        ("b", lambda: smoke.dup8_plan(T, dhalf_t, ddim_t,
                                      T.JoinType.LEFT_OUTER, True)),
    ]
    compact, spread = C.compact_kernel, HJ.spread_kernel
    recorded = []
    for label, plan in plans:
        def rec_compact(payloads, mask, out_cap, label=label):
            recorded.append((label, "compaction", (list(payloads), mask,
                                                   out_cap)))
            return compact(payloads, mask, out_cap)

        def rec_spread(payloads, base, out_cap, add_row=(), label=label):
            recorded.append((label, "spread", (list(payloads), base, out_cap,
                                               tuple(add_row))))
            return spread(payloads, base, out_cap, add_row)

        C.compact_kernel, HJ.spread_kernel = rec_compact, rec_spread
        try:
            T.execute(plan())
        finally:
            C.compact_kernel, HJ.spread_kernel = compact, spread
    sys.path.pop(0)
    torch.cuda.synchronize()
    return [(f"{label}:{kind}", kind, a) for label, kind, a in recorded
            if calls is None or label in calls or f"{label}:{kind}" in calls]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[str(HERE)])
    ap.add_argument("--calls", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_torch_compaction_spread: no CUDA device")
    # this checkout's data helpers and operators, whatever tree the
    # wrappers come from
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    calls = record(smoke, args.calls)
    first = {}
    for turn, root in enumerate(args.roots):
        compact, spread = wrappers(root)
        for name, kind, a in calls:
            if kind == "compaction":
                pays, mask, cap = a
                n = mask.shape[0]
                kept = min(int(mask.sum()), cap)
                width = sum(p.element_size() for p in pays)
                nbytes = n * (1 + width) + kept * width
                fn = lambda: compact(pays, mask, cap)  # noqa: E731
                outs, cnt = fn()
                outs = [o[:int(cnt)] for o in outs]
                shape = {"rows": n, "lanes": [str(p.dtype) for p in pays],
                         "kept": kept, "out_cap": cap}
            else:
                pays, base, cap, add_row = a
                live = int((base != I32_MAX).sum())
                width = sum(p.element_size() for p in pays)
                nbytes = live * (4 + width) + cap * width
                fn = lambda: spread(pays, base, cap, add_row)  # noqa: E731
                outs = fn()
                shape = {"sources": base.shape[0], "live": live,
                         "lanes": [str(p.dtype) for p in pays],
                         "add_row": list(add_row), "out_cap": cap}
            raw = [o.view(torch.uint8) for o in outs]
            same = name not in first or all(
                torch.equal(x, y) for x, y in zip(raw, first[name]))
            first.setdefault(name, raw)
            print(json.dumps({"turn": turn + 1, "root": root, "call": name,
                              **shape, "same_as_first": same,
                              "ms": smoke.cuda_ms(torch, fn),
                              "bound_ms": smoke.bound_ms(nbytes),
                              "kernels_ms": profile_split(fn)}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
