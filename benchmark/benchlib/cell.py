"""One run of a cell: set-up, warm-up, the measured window (or the traced
one), then every answer of the window against the plain reference.

The loop is closed with one client, TPC-H's power test: draw the next
query from the traffic, build its plan, ``execute`` it (one host sync at
its end), copy the result rows to host numpy, and only then draw the next.
A query's latency runs from the plan's construction to its rows on the
host.  The traced run makes the four calls that ``execute`` makes, in its
order, each inside a span of the benchmark's own.
"""
from __future__ import annotations

import gc
import itertools
import math
import pathlib
import sys
import time
import traceback
from dataclasses import dataclass

from benchlib import compare, registry, stats, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "supersonic_tpu")
SHOWN_ERRORS = 3


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``supersonic_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Result:
    inst: traffic.Instance
    names: list
    cols: dict
    seconds: float
    error: str = ""


def build_tables(T, data: dict, device) -> dict:
    """The port's Tables of the generated host arrays."""
    tables = {}
    for name, types in data["types"].items():
        words = data["words"].get(name, {})
        schema = T.TupleSchema.of(*[(c, getattr(T.DataType, t), False)
                                    for c, t in types])
        tables[name] = T.Table.from_numpy(
            schema, {c: data["tables"][name][c] for c, _ in types}, None,
            {c: T.Dictionary(w) for c, w in words.items()}, device=device)
    return tables


def reference_data(data: dict, device):
    """The same host arrays on ``device`` for the reference."""
    import torch

    from reference.common import Data

    return Data({t: {c: torch.from_numpy(a).to(device)
                     for c, a in cols.items()}
                 for t, cols in data["tables"].items()}, data["words"])


def fact_rows(data: dict) -> int:
    return len(next(iter(data["tables"][data["fact"]].values())))


class Program:
    """The system under test over one data set: each query's plan built
    anew and run through ``execute``, its rows copied to the host."""

    def __init__(self, T, tables: dict, queries: list):
        self.T = T
        self.tables = tables
        self.plans = {q: registry.load_module("queries", q) for q in queries}
        self.host_s = {"bind": 0.0}

    def answer(self, inst):
        table = self.T.execute(
            self.plans[inst.query].plan(self.T, self.tables, inst.params))
        return table.schema.names(), table.to_numpy()

    def answer_traced(self, inst):
        """``execute``'s four calls, each in a span, and the copy."""
        from torch.profiler import record_function

        from supersonic_tpu_torch.ops import base

        with record_function("bench.plan"):
            plan = self.plans[inst.query].plan(self.T, self.tables,
                                               inst.params)
        t0 = time.perf_counter()
        with record_function("bench.bind"):
            run, _bound, leaves = base.compile_plan(plan)
        self.host_s["bind"] += time.perf_counter() - t0
        with record_function("bench.prepare"):
            leaves = base.prepare_leaves(leaves, run.lazy)
        with record_function("bench.run"):
            table, flags, names = run(leaves)
        with record_function("bench.finish"):
            base.finish(run, flags, names)
        with record_function("bench.copy"):
            return table.schema.names(), table.to_numpy()


def window(step, queries, seconds: float):
    """Run ``step`` over ``queries`` until ``seconds`` have passed: (results,
    seconds from the first query's start to the last one's end)."""
    results = []
    start = end = time.perf_counter()
    deadline = start + seconds
    while end < deadline:
        inst = next(queries)
        t0 = time.perf_counter()
        try:
            names, cols = step(inst)
            err = ""
        except Exception:  # a query that raises is a failed query
            names, cols, err = None, None, traceback.format_exc()
        end = time.perf_counter()
        results.append(Result(inst, names, cols, end - t0, err))
    return results, end - start


def judge(results, data, limits: dict, device, low=False):
    """Each answer against the reference: (numbers compared, one
    (raised, exact_ok, max_rel) a result).  The reference's answer to each
    distinct query and parameters is computed once."""
    ref = reference_data(data, device)
    answers = {}
    judged = []
    for r in results:
        if r.error:
            judged.append((True, False, math.inf))
            continue
        if r.inst.key not in answers:
            answers[r.inst.key] = registry.load_module(
                "reference", r.inst.query).answer(ref, r.inst.params, low)
        ok, rel = compare.compare(r.names, r.cols, answers[r.inst.key])
        judged.append((False, ok, rel))
    return compare.checks(judged, limits), judged


def load(T, data: dict, device, log_s) -> dict:
    """The port's Tables of ``data`` on ``device``, the card's memory peak
    started anew before them."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    tables = build_tables(T, data, device)
    log_s["tables"] = time.perf_counter() - t
    return tables


def warm_up(answer, cell, seed: int, device, log_s) -> list:
    """Two rounds of the cell's queries through ``answer``, drawn from
    ``seed + 1``: the seconds of each call of the second round."""
    import torch

    n = len(cell.traffic["queries"])
    seconds = []
    t = time.perf_counter()
    warm = traffic.stream(cell.traffic, seed + 1)
    for inst in itertools.islice(warm, 2 * n):
        t0 = time.perf_counter()
        answer(inst)
        seconds.append(time.perf_counter() - t0)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    log_s["warm_up"] = time.perf_counter() - t
    return seconds[n:]


def setup(cell, seed: int, device, log_s):
    """Generate the data, build the tables, warm up the cell's queries:
    (data, program)."""
    import supersonic_tpu_torch as T

    t = time.perf_counter()
    gen = registry.load_module("generators", cell.config["generator"])
    data = gen.generate(cell.config, seed, device)
    log_s["generate"] = time.perf_counter() - t
    tables = load(T, data, device, log_s)
    prog = Program(T, tables, [q["query"] for q in cell.traffic["queries"]])
    warm_up(prog.answer, cell, seed, device, log_s)
    return data, prog


def device_info(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def _traced_window(prog, queries, seconds, device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    results, _ = window(prog.answer_traced, queries, seconds)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    prof.stop()
    events = prof.profiler.kineto_results.events()
    log(f"profiler: {len(events)} events, stopped and read in "
        f"{time.perf_counter() - t:.1f} s")
    return results, events


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        started: float, config: dict = None) -> dict:
    """One run of ``workload``; returns the result line.  ``started`` is the
    process's start on the ``time.perf_counter`` clock; ``config``
    replaces the cell's configuration (the tests' small sizes)."""
    import torch

    cell = registry.cell(workload)
    if config is not None:
        cell.config = config
    log_s = {"start_and_imports": time.perf_counter() - started}
    data, prog = setup(cell, seed, device, log_s)
    queries = traffic.stream(cell.traffic, seed)
    setup_s = time.perf_counter() - started
    log(f"{workload} seed {seed}: setup {setup_s:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in log_s.items()) + ")")
    if traced:
        results, events = _traced_window(prog, queries, seconds, device)
    else:
        results, wall = window(prog.answer, queries, seconds)
    dev = device_info(device)
    bind_s = prog.host_s["bind"]
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, bad = verdict(cell, results, data, device)
    line = {"correct": compare.passed(numbers), "attempted": len(results),
            "failed": sum(bad), "metrics": {}, "device": dev}
    if traced:
        tr = trace.reduce(events, trace.own_kernel_names(_program_dir()),
                          len(results) - sum(bad), {"bind": bind_s})
        for m in cell.per_layer:
            value = registry.load_module("metrics", m["name"]).read(tr)
            if value is not None:
                line["metrics"][m["name"]] = {"value": value,
                                              "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = trace.breakdown(tr)
    else:
        line["metrics"] = end_to_end(cell, results, bad, data, wall,
                                     setup_s)
    line["checks"] = numbers
    return line


def verdict(cell, results, data, device):
    """Every answer of the window against the reference, its time and the
    first errors logged: (numbers compared, one flag a result: raised or
    wrong)."""
    t = time.perf_counter()
    numbers, judged = judge(results, data, cell.traffic.get("limits", {}),
                            device)
    log(f"reference and comparison: {time.perf_counter() - t:.2f} s, "
        f"{len(results)} answers, {len({r.inst.key for r in results})} "
        f"distinct")
    for r in [r for r in results if r.error][:SHOWN_ERRORS]:
        log(f"query {r.inst.query} {r.inst.params} raised:\n{r.error}")
    return numbers, [not ok for _, ok, _ in judged]


def end_to_end(cell, results, bad, data, wall: float, setup_s: float):
    """The cell's end-to-end metrics of a window of ``wall`` seconds: a
    query that raised or was wrong has an infinite latency, and the rate
    counts the whole fact table for each correct one."""
    lat = [math.inf if b else r.seconds for r, b in zip(results, bad)]
    values = stats.window_metrics(
        lat, fact_rows(data) * (len(results) - sum(bad)), wall)
    values["setup_s"] = setup_s
    out = {}
    for m in cell.end_to_end:
        v = values[m["name"]]
        out[m["name"]] = {"value": v if math.isfinite(v) else None,
                          "unit": m["unit"]}
    return out


def _program_dir():
    import supersonic_tpu_torch

    return pathlib.Path(supersonic_tpu_torch.__file__).parent
