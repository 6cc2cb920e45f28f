"""A run of a cell on P > 1 cards: the launcher that starts one rank a card
(``benchmark/rank.py``, ``benchlib.rankrun``), watches them, and makes the
result line of their reports.

Rank r runs on card r in a process of its own session, so that killing its
process group also ends what it started (a kernel build).  Each rank tells
the launcher, on a pipe, every state it enters and how long it may stay
there without another word: its set-up (``rankrun.SETUP_S``), each query of
the window (``rankrun.QUERY_TIMES`` times the slowest warm query, at least
``rankrun.QUERY_S``), the judge (``rankrun.JUDGE_S``).  A rank that exits
with another code than 0, exits without its report, or stays silent past
its bound ends the run: every rank is killed and waited for, and ``Failed``
is raised, so no result is printed.  A rank dies with the launcher
(``PR_SET_PDEATHSIG``).

The line has the keys of a one-card run.  ``correct``, ``attempted``,
``failed``, ``checks`` and the end-to-end metrics are rank 0's, the
coordinator's.  ``device.count`` is P; ``memory_peak_bytes`` the largest of
the ranks' peaks, each listed beside it.  In a traced run each per-layer
metric is the worst of the ranks' readings by the metric's ``better`` (the
card that sets the pace), with each rank's reading under ``ranks``;
``busy_s`` and ``window_s`` are the means over the ranks, so that their
quotient is the busy share of all P cards; ``breakdown`` is rank 0's.
"""
from __future__ import annotations

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

from benchlib import cell, registry, rankrun

EXIT_S = 60   # seconds a rank may take to exit once it has reported


class Failed(RuntimeError):
    """The run of the ranks failed: ``code`` is the exit code to give."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _command(r: int, ranks: int, workload: str, seed: int, seconds: float,
             traced: bool, device: str, started: float, address: str,
             config, control: bool) -> list:
    cmd = [sys.executable, str(registry.BENCH / "rank.py"),
           "--workload", workload, "--seed", str(seed),
           "--seconds", repr(float(seconds)), "--trace", str(int(traced)),
           "--device", device, "--rank", str(r), "--ranks", str(ranks),
           "--address", address, "--started", repr(started),
           "--parent", str(os.getpid())]
    if config is not None:
        cmd += ["--config", json.dumps(config)]
    if control:
        cmd.append("--control")
    return cmd


def _read(r: int, pipe, messages: queue.Queue) -> None:
    for line in pipe:
        messages.put((r, line.rstrip("\n")))
    messages.put((r, None))


def _kill(procs) -> None:
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    for p in procs:
        p.wait()


def run_ranks(workload: str, ranks: int, seed: int, seconds: float,
              traced: bool, device: str, started: float, config=None,
              control: bool = False) -> list:
    """Start the ``ranks`` processes of one run and return their reports
    in rank order; raises ``Failed`` where a rank fails or hangs."""
    address = f"localhost:{free_port()}"
    procs = []
    messages: queue.Queue = queue.Queue()
    reports = [None] * ranks
    ended = [False] * ranks
    now = time.monotonic()
    states = [("start", rankrun.SETUP_S, now)] * ranks
    try:
        for r in range(ranks):
            procs.append(subprocess.Popen(
                _command(r, ranks, workload, seed, seconds, traced, device,
                         started, address, config, control),
                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, text=True,
                start_new_session=True))
            cell.log(f"rank {r}: pid {procs[-1].pid}")
            threading.Thread(target=_read, args=(r, procs[-1].stdout,
                                                 messages),
                             daemon=True).start()
        while not all(ended):
            try:
                r, msg = messages.get(timeout=0.25)
            except queue.Empty:
                r, msg = None, ""
            if r is not None:
                if msg is None:
                    ended[r] = True
                    if reports[r] is None:
                        procs[r].wait()
                        raise Failed(4, f"rank {r} exited with "
                                        f"{procs[r].returncode} in "
                                        f"{states[r][0]}, before its report")
                elif msg.startswith(rankrun.PREFIX + "state "):
                    name, bound = msg.split()[2:4]
                    states[r] = (name, float(bound), time.monotonic())
                elif msg.startswith(rankrun.PREFIX + "report "):
                    reports[r] = json.loads(msg.split(" ", 2)[2])
                    states[r] = ("exit", EXIT_S, time.monotonic())
            now = time.monotonic()
            for k, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise Failed(4, f"rank {k} exited with {p.returncode} "
                                    f"in {states[k][0]}")
                name, bound, since = states[k]
                if not ended[k] and now - since > bound:
                    raise Failed(4, f"rank {k} gave no word for {bound:g} s "
                                    f"in {name}: hung")
        for p in procs:
            p.wait()
        for k, p in enumerate(procs):
            if p.returncode != 0:
                raise Failed(4, f"rank {k} exited with {p.returncode} "
                                f"after its report")
    finally:
        _kill(procs)
    return reports


def worst(values: list, better: str):
    """The reading of the card that sets the pace: the largest where lower
    is better, the smallest where higher is; None where no rank read one."""
    got = [v for v in values if v is not None]
    if not got:
        return None
    return max(got) if better == "lower" else min(got)


def combine(c, reports: list, traced: bool) -> dict:
    """The result line of the ranks' reports (``c``: the cell)."""
    streams = {json.dumps(rep["stream"], sort_keys=True) for rep in reports}
    if len(streams) > 1:
        raise Failed(4, f"the ranks ran different streams: {sorted(streams)}")
    found = sorted({m for rep in reports for m in rep["forbidden"]})
    if found:
        raise Failed(3, f"loaded in a rank: {', '.join(found)}")
    first = reports[0]
    peaks = [rep["device"]["memory_peak_bytes"] for rep in reports]
    dev = {"platform": first["device"]["platform"],
           "kind": first["device"]["kind"], "count": len(reports),
           "memory_peak_bytes": max(peaks), "memory_peak_bytes_ranks": peaks}
    line = {"correct": first["correct"], "attempted": first["attempted"],
            "failed": first["failed"], "metrics": {}, "device": dev}
    if traced:
        for m in c.per_layer:
            values = [rep["metrics"][m["name"]] for rep in reports]
            value = worst(values, m["better"])
            if value is not None:
                line["metrics"][m["name"]] = {"value": value,
                                              "unit": m["unit"],
                                              "ranks": values}
        for key in ("busy_s", "window_s"):
            values = [rep[key] for rep in reports]
            dev[key] = sum(values) / len(values)
            dev[key + "_ranks"] = values
        line["breakdown"] = first["breakdown"]
    else:
        line["metrics"] = first["metrics"]
    line["checks"] = first["checks"]
    return line


def run(workload: str, ranks: int, seed: int, seconds: float, traced: bool,
        device: str, started: float, config=None) -> dict:
    """One run of ``workload`` on ``ranks`` cards; returns the result
    line, or raises ``Failed``."""
    reports = run_ranks(workload, ranks, seed, seconds, traced, device,
                        started, config)
    return combine(registry.cell(workload), reports, traced)
