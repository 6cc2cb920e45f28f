"""One rank of a cell on P > 1 cards (``chips`` in BENCHMARK.json), as
``benchmark/rank.py`` runs it for the launcher (``benchlib.cards``).

Each rank joins the port's process group with
``supersonic_tpu_torch.parallel.initialize`` (NCCL between cards, gloo on
the CPU), and a gloo group of the harness's own beside it that carries
every control message, so that none of them shows on a card's trace.

Set-up: the rank's share of the data (the configuration's ``placement``,
such as ``{"lineorder": "rows"}``, gives each rank one of P contiguous
ranges of the named table's rows; every other table is whole on every
rank), made by a generator that takes ``part=(rank, ranks)``, or else cut
from the whole data set; its Tables and a warm-up of two rounds of the
cell's queries, as on one card (``cell.load``, ``cell.warm_up``); then a
barrier.  A query of the window may take ``QUERY_TIMES`` times the
slowest of the warm-up's second round, and never less than ``QUERY_S``.

The window: rank 0, the coordinator, draws the stream from the seed as a
one-card run does and sends each query's index in the stream, or a stop,
to every rank; every rank draws the same stream and runs that query's
``dist_answer(T, mesh, tables, params)`` from ``queries/<query>.dist.py``,
which returns the result Table on rank 0 and None on the others; rank 0
copies it to the host.  A query's latency runs from its dispatch to rank
0's rows on the host.  After each query the ranks agree whether any of
them raised: a failure anywhere fails that query once.

After the window each rank reads its memory peak and frees its program
state; rank 0 gathers the shares that it lacks, as host arrays, and holds
every answer against the reference over the whole data set on its own
card, as a one-card run does.  With ``--trace 1`` every rank profiles its
own window and reads each per-layer metric on its own trace.  Each rank
sends its report to the launcher, which makes the result line.
"""
from __future__ import annotations

import contextlib
import datetime
import gc
import hashlib
import inspect
import json
import time
import traceback

from benchlib import cell, compare, registry, trace, traffic

SETUP_S = 1000   # a rank's set-up, the first run's kernel build included
JUDGE_S = 600    # the profiler's stop, the shares, the reference, the report
QUERY_S = 10     # the least bound of a query of the window
QUERY_TIMES = 20  # a query's bound over the slowest warm query
STOP = -1        # the index that ends the window
PREFIX = "@bench "


class Link:
    """The rank's word to the launcher, one line each on the pipe it was
    given: each state it enters, with the seconds it may stay there
    without another line, and its report at the end."""

    def __init__(self, out):
        self.out = out

    def state(self, name: str, bound_s: float) -> None:
        self._send(f"state {name} {bound_s}")

    def report(self, rep: dict) -> None:
        self._send("report " + json.dumps(rep))

    def _send(self, text: str) -> None:
        self.out.write(PREFIX + text + "\n")
        self.out.flush()


def query_bound_s(warm_s: list) -> float:
    """The seconds a query of the window may take, from the warm-up's."""
    return max(QUERY_S, QUERY_TIMES * max(warm_s))


def rows_of(n: int, rank: int, ranks: int) -> tuple:
    """The range of ``n`` rows that ``rank`` of ``ranks`` holds."""
    return n * rank // ranks, n * (rank + 1) // ranks


def placement(config: dict) -> dict:
    placed = config.get("placement", {})
    for table, how in placed.items():
        if how != "rows":
            raise ValueError(f"placement of {table!r} is {how!r}; a table "
                             f"is placed by 'rows' or not at all")
    return placed


def share(config: dict, seed: int, rank: int, ranks: int, device) -> dict:
    """This rank's data: the generator's share where it takes ``part``,
    else the whole data set with each placed table cut to this rank's
    rows."""
    gen = registry.load_module("generators", config["generator"])
    placed = placement(config)
    if "part" in inspect.signature(gen.generate).parameters:
        return gen.generate(config, seed, device, part=(rank, ranks))
    data = gen.generate(config, seed, device)
    for table in placed:
        cols = data["tables"][table]
        lo, hi = rows_of(len(next(iter(cols.values()))), rank, ranks)
        data["tables"][table] = {c: a[lo:hi].copy() for c, a in cols.items()}
    return data


def gather_shares(data: dict, placed, rank: int, ranks: int, group):
    """On rank 0 the whole data set: each placed table's shares joined in
    rank order, sent as host arrays over ``group``; None on the others,
    once they have sent theirs."""
    import numpy as np
    import torch
    import torch.distributed as dist

    cols = [(t, c) for t in sorted(placed) for c in sorted(data["tables"][t])]
    counts = [None] * ranks
    dist.all_gather_object(counts, [len(data["tables"][t][c])
                                    for t, c in cols], group=group)
    if rank != 0:
        for (t, c), n in zip(cols, counts[rank]):
            if n:
                dist.send(torch.from_numpy(
                    np.ascontiguousarray(data["tables"][t][c])), 0,
                    group=group)
        return None
    parts = {tc: [data["tables"][tc[0]][tc[1]]] for tc in cols}
    for r in range(1, ranks):
        for (t, c), n in zip(cols, counts[r]):
            buf = np.empty(n, dtype=data["tables"][t][c].dtype)
            if n:
                dist.recv(torch.from_numpy(buf), r, group=group)
            parts[(t, c)].append(buf)
    tables = dict(data["tables"])
    for t in placed:
        tables[t] = {c: np.concatenate(parts[(t, c)])
                     for c in data["tables"][t]}
    return dict(data, tables=tables)


def _no_span(name):
    return contextlib.nullcontext()


def _bench_span(name):
    from torch.profiler import record_function

    return record_function("bench." + name)


class Program:
    """The system under test on one rank: each query's ``dist_answer``
    over this rank's Tables, and on rank 0 its rows copied to the host."""

    def __init__(self, T, mesh, tables: dict, queries: list):
        self.T = T
        self.mesh = mesh
        self.tables = tables
        self.plans = {q: registry.load_module("queries", q + ".dist")
                      for q in queries}

    def answer(self, inst, span=_no_span):
        with span("run"):
            table = self.plans[inst.query].dist_answer(
                self.T, self.mesh, self.tables, inst.params)
        if self.mesh.rank != 0:
            return None, None
        with span("copy"):
            return table.schema.names(), table.to_numpy()


def broadcast(group, value: int) -> int:
    """Rank 0's ``value`` on every rank of the harness's group."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64)
    dist.broadcast(t, 0, group=group)
    return int(t[0])


def count_raised(group, raised: bool) -> int:
    """How many ranks of the harness's group raised."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(raised)], dtype=torch.int64)
    dist.all_reduce(t, group=group)
    return int(t[0])


def window(prog, group, queries, seconds: float, rank: int, link,
           bound_s: float, span=_no_span):
    """The closed loop until ``seconds`` have passed on rank 0: (results,
    seconds from the first query's dispatch to the last one's rows, the
    keys of the queries run).  Rank 0 decides when the window ends."""
    results, keys = [], []
    start = end = time.perf_counter()
    deadline = start + seconds
    n = 0
    while True:
        t0 = time.perf_counter()
        with span("dispatch"):
            sent = broadcast(group, n if end < deadline else STOP)
        if sent == STOP:
            break
        if sent != n:
            raise RuntimeError(f"rank {rank} was sent query {sent} of the "
                               f"stream where it expected {n}")
        inst = next(queries)
        try:
            names, cols = prog.answer(inst, span)
            err = ""
        except Exception:  # a query that raises is a failed query
            names, cols, err = None, None, traceback.format_exc()
        end = time.perf_counter()
        with span("agree"):
            raised = count_raised(group, bool(err))
        if raised and not err:
            err = f"raised on {raised} other rank(s)"
        link.state("window", bound_s)
        keys.append(inst.key)
        results.append(cell.Result(inst, names, cols, end - t0, err))
        n += 1
    return results, end - start, keys


def stream_digest(keys) -> dict:
    return {"queries": len(keys),
            "digest": hashlib.sha256(repr(keys).encode()).hexdigest()}


def _per_layer(c, events, queries: int, rank: int) -> dict:
    """The per-layer metrics of this rank's traced window.  The plans of a
    query on many cards are bound inside the port's distributed calls,
    where no span of the benchmark's own reaches: ``host.bind_ms`` finds
    nothing to read, and ``entry.bind_ms`` (the program's ``query.bind``
    spans) carries the binds."""
    tr = trace.reduce(events, trace.own_kernel_names(cell._program_dir()),
                      queries, {})
    out = {"metrics": {m["name"]: registry.load_module(
        "metrics", m["name"]).read(tr) for m in c.per_layer},
        "busy_s": tr.busy_s, "window_s": tr.window_s}
    if rank == 0:
        out["breakdown"] = trace.breakdown(tr)
    return out


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        started: float, rank: int, ranks: int, address: str, link,
        config: dict = None, control: bool = False) -> None:
    """One rank's run; its report goes to ``link``.  ``started`` is the
    launcher's start on ``time.perf_counter``'s clock (CLOCK_MONOTONIC,
    one clock for every process of the host); ``config`` replaces the
    cell's configuration; ``control`` has rank 0 judge the low-precision
    reference's answers as well (``control.py``)."""
    import torch
    import torch.distributed as dist

    import supersonic_tpu_torch as T
    import supersonic_tpu_torch.parallel  # noqa: F401 (T.parallel)

    link.state("setup", SETUP_S)
    c = registry.cell(workload)
    if config is not None:
        c.config = config
    log_s = {"start_and_imports": time.perf_counter() - started}
    T.parallel.initialize(address, ranks, rank, device)
    group = dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(seconds=SETUP_S))
    mesh = T.parallel.make_mesh()
    dev = mesh.device
    on_card = dev.type == "cuda"
    t = time.perf_counter()
    data = share(c.config, seed, rank, ranks, dev)
    log_s["generate"] = time.perf_counter() - t
    tables = cell.load(T, data, dev, log_s)
    prog = Program(T, mesh, tables, [q["query"] for q in c.traffic["queries"]])
    bound_s = query_bound_s(cell.warm_up(prog.answer, c, seed, dev, log_s))
    link.state("ready", SETUP_S)
    dist.barrier(group=group)
    setup_s = time.perf_counter() - started
    cell.log(f"{workload} rank {rank} of {ranks} seed {seed}: setup "
             f"{setup_s:.2f} s ("
             + ", ".join(f"{k} {v:.2f} s" for k, v in log_s.items())
             + f"); a query's bound {bound_s:.2f} s")
    queries = traffic.stream(c.traffic, seed)
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        link.state("profile", SETUP_S)
        prof.start()
        dist.barrier(group=group)  # every rank's window opens together
        link.state("window", bound_s)
        results, wall, keys = window(prog, group, queries, seconds, rank, link,
                                     bound_s, _bench_span)
        link.state("judge", JUDGE_S)
        if on_card:
            torch.cuda.synchronize(dev)
        prof.stop()
        events = prof.profiler.kineto_results.events()
    else:
        link.state("window", bound_s)
        results, wall, keys = window(prog, group, queries, seconds, rank, link,
                                     bound_s)
        link.state("judge", JUDGE_S)
    rep = {"rank": rank, "device": cell.device_info(dev),
           "stream": stream_digest(keys)}
    del prog, tables
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    whole = gather_shares(data, placement(c.config), rank, ranks, group)
    del data
    if rank == 0:
        cell.log(f"shares gathered on rank 0: "
                 f"{time.perf_counter() - t:.2f} s")
    good = 0
    if rank == 0:
        good = _judge(c, results, whole, dev, wall, setup_s, traced,
                      control, rep)
    good = broadcast(group, good)
    if traced:
        rep.update(_per_layer(c, events, good, rank))
    rep["forbidden"] = cell.forbidden_modules()  # once all has been loaded
    link.report(rep)
    dist.destroy_process_group(group)
    dist.destroy_process_group()


def _judge(c, results, whole, dev, wall, setup_s, traced, control,
           rep) -> int:
    """Rank 0's answers against the reference over the whole data set,
    into ``rep``; returns the count of correct answers."""
    numbers, bad = cell.verdict(c, results, whole, dev)
    rep.update(correct=compare.passed(numbers), attempted=len(results),
               failed=sum(bad), checks=numbers,
               latency_ms=[r.seconds * 1e3 for r in results])
    if not traced:
        rep["metrics"] = cell.end_to_end(c, results, bad, whole, wall,
                                         setup_s)
    if control:
        import control as control_mod

        rep["control"], _ = cell.judge(
            control_mod.control_results(results, whole, dev), whole,
            c.traffic.get("limits", {}), dev)
    return len(results) - sum(bad)
