#!/usr/bin/env python3
"""The port's own spans against the profiler's view of one traced window,
on a CUDA card, for each named benchmark cell:

    python3 scripts/check_torch_tracing.py [--seconds S] [--seed N]
        [--out DIR] CELL [CELL ...]

Each cell runs as the benchmark's ``--trace 1`` run does (set-up, warm-up,
then ``--seconds`` under ``torch.profiler``), without the comparison with
the reference, and prints one JSON line with:

- ``metrics``: every per-layer metric of the cell;
- ``idle_s``: the idle that ``benchlib/trace.py`` charges to each
  ``bench.*`` span beside the idle that ``benchlib/program.py`` charges to
  the program's outermost ``query.*`` span of the same phase (their
  children included), and the window's seconds;
- ``dtoh_in_sync``: the window's device-to-host copies that start inside
  a ``sync.*`` span of the program, of all;
- ``dtoh_paired``: the k-th copy against the k-th sync span, and
  ``host_clock_us``: the program's ``query.*`` spans against the
  benchmark's ``bench.*`` events (both host stamps);
- ``bind_ms_p50_max``: the median and the longest outermost bind;
- ``per_query``: ``queries`` answered, each operator's own device ms and
  each span's own idle ms a query (by class and route, and by span name),
  the operator routes and the host-sync sites a query.

The lines also go to ``DIR/tracing_<cell>.json`` (``chiprun_out`` by
default).
"""
import argparse
import bisect
import collections
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"


def check(workload: str, seed: int, seconds: float) -> dict:
    import torch

    from benchlib import cell, program, registry, trace, traffic

    c = registry.cell(workload)
    log_s: dict = {}
    _data, prog = cell.setup(c, seed, "cuda", log_s)
    results, events = cell._traced_window(
        prog, traffic.stream(c.traffic, seed), seconds, "cuda")
    failed = sum(1 for r in results if r.error)
    tr = trace.reduce(events, trace.own_kernel_names(
        ROOT / "supersonic_tpu_torch"), len(results) - failed,
        {"bind": prog.host_s["bind"]})
    metrics = {m["name"]: registry.load_module("metrics", m["name"]).read(tr)
               for m in c.per_layer}
    v = program.view(tr)
    n = tr.queries
    idle = {"window": tr.window_s}
    for phase in ("plan", "bind", "prepare", "run", "finish", "copy"):
        ours = sum(v.idle_ns[i] for i in v.top("query." + phase)) / 1e9
        idle[phase] = [tr.idle_s.get(phase, 0.0),
                       ours if phase != "plan" else None]
    syncs = [(s[1], s[2]) for s in v.spans
             if s[0].startswith("sync.") and s[5].get("transfers")]
    syncs.sort()
    starts = [a for a, _ in syncs]
    copies = [s for name, kind, s, _, _ in tr.device
              if kind == "memcpy" and "DtoH" in name]
    inside = 0
    for t in copies:
        i = bisect.bisect_right(starts, t) - 1
        # spans of one thread do not overlap: the last one opened before t
        inside += i >= 0 and syncs[i][1] >= t
    paired = _paired(syncs, sorted(copies))
    host_clock = _host_clock(events, v)
    binds = sorted(v.spans[i][2] - v.spans[i][1] for i in v.top("query.bind"))
    node_ms = collections.Counter()
    node_idle = collections.Counter()
    span_idle = collections.Counter()
    routes = collections.Counter()
    sites = collections.Counter()
    for s, ms, own in zip(v.spans, v.own_device_ms, v.own_idle_ns):
        key = s[0]
        if ms is not None:
            key = f"{s[5]['name']}[{s[5]['route']}]" if s[5].get("route") \
                else s[5]["name"]
            node_ms[key] += ms
            node_idle[key] += own / 1e6
            routes[key] += 1
        elif s[0].startswith("sync."):
            sites[s[0][5:]] += s[5].get("transfers", 0)
        span_idle[s[0] if not s[0].startswith("op.") else key] += own / 1e6

    def per_query(counter, digits=4):
        return {k: round(x / n, digits) for k, x in counter.most_common()}

    return {"cell": workload, "seed": seed, "seconds": seconds,
            "device": torch.cuda.get_device_name(0),
            "queries": len(results), "failed": failed,
            "metrics": metrics, "idle_s": idle,
            "dtoh_in_sync": [inside, len(copies)],
            "dtoh_paired": paired,
            "host_clock_us": host_clock,
            "bind_ms_p50_max": [binds[len(binds) // 2] / 1e6,
                                binds[-1] / 1e6] if binds else [],
            "host_syncs": tr.count("memcpy", "DtoH") / n,
            "busy_s": tr.busy_s,
            "per_query": {"node_device_ms": per_query(node_ms),
                          "node_idle_ms": per_query(node_idle),
                          "span_idle_ms": per_query(span_idle),
                          "routes": per_query(routes, 3),
                          "sync_sites": per_query(sites, 3)}}


def _paired(syncs, copies) -> dict:
    """The k-th device-to-host copy against the k-th sync span of one
    transfer, where their counts agree: how many start inside their span,
    the quantiles (0, 10, 50, 90, 100%) of each copy's start less its
    span's start (us), and the median of that in the window's first and
    last tenth (a drift between the device's and the host's clocks)."""
    if len(syncs) != len(copies) or not copies:
        return {"pairs": 0, "of": [len(syncs), len(copies)]}
    d = [(t - a) / 1e3 for (a, _), t in zip(syncs, copies)]
    inside = sum(a <= t <= b for (a, b), t in zip(syncs, copies))
    tenth = max(len(d) // 10, 1)
    q = sorted(d)
    return {"pairs": len(d), "inside": inside,
            "start_after_us": [round(q[int(f * (len(q) - 1))], 3)
                               for f in (0, 0.1, 0.5, 0.9, 1)],
            "first_last_tenth_us": [round(statistics.median(d[:tenth]), 3),
                                    round(statistics.median(d[-tenth:]), 3)]}


def _host_clock(events, v) -> list:
    """The program's outermost ``query.<phase>`` spans against the
    profiler's own ``bench.<phase>`` events around the same calls, in
    order: the quantiles (0, 50, 100%) of how far each program span starts
    after, and ends before, its benchmark span (us).  Both are host
    stamps, so small positive numbers say the two clocks agree."""
    import torch

    bench = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in events
                   if e.device_type() == torch.autograd.DeviceType.CPU
                   and e.name().startswith("bench."))
    ours = sorted((s[1], s[2], "bench." + s[0][6:]) for s in v.spans
                  if s[3] < 0 and s[0].startswith("query."))
    by = {}
    for side in (bench, ours):
        for a, b, name in side:
            by.setdefault(name, ([], []))[side is ours].append((a, b))
    after, before = [], []
    for theirs, mine in by.values():
        if len(theirs) != len(mine):
            continue
        for (a0, b0), (a1, b1) in zip(theirs, mine):
            after.append((a1 - a0) / 1e3)
            before.append((b0 - b1) / 1e3)
    if not after:
        return []
    after.sort()
    before.sort()
    return [[round(x[int(f * (len(x) - 1))], 3) for f in (0, 0.5, 1)]
            for x in (after, before)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1700000001)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    import run as bench_run

    bench_run.caches_inside_checkout()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for workload in args.cells:
        t = time.perf_counter()
        line = check(workload, args.seed, args.seconds)
        line["wall_s"] = time.perf_counter() - t
        text = json.dumps(line)
        (out / f"tracing_{workload}.json").write_text(text + "\n")
        print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
