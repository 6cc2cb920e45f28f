"""Finds what a cell is made of by its names in ``BENCHMARK.json``.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, a schema's data generator ``generators/<schema>.py``,
a query's plan builder ``queries/<query>.py`` and its plain reference
``reference/<query>.py``, a per-layer metric ``metrics/<metric>.py``.  A
later change adds a cell, a configuration, a query or a metric by adding
such files and entries; no file here needs an edit for it.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module, loaded once a process (names may
    hold dots, as metric names do, so the file is loaded by its path)."""
    key = f"_bench_{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} module {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads``, with its files read."""

    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def cell(workload: str) -> Cell:
    m = manifest()
    entry = next((w for w in m["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise LookupError(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json("configs", entry["config"])
    traffic = load_json("traffic", entry["traffic"])
    if config["schema"] != traffic["schema"]:
        raise LookupError(f"traffic {entry['traffic']!r} is for schema "
                          f"{traffic['schema']!r}, config "
                          f"{entry['config']!r} holds {config['schema']!r}")

    def ours(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [x for x in m["end_to_end"] if ours(x)]
    reported = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if ours(x) and x["moves"] in reported]
    return Cell(workload, config, traffic, e2e, layer)
