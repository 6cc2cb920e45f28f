"""Whole runs of small cells on the CPU: what a run loads, how it exits
without a card, a cell added as files alone, the control and the faults
that ``correct`` has to catch."""
import json
import shutil
import subprocess
import sys
import time

import pytest
from conftest import BENCH, CELLS, small_config

from benchlib import cell, registry

ROOT = BENCH.parent


def _run(workload, seed=2 ** 31 + 17, seconds=0.3, traced=False,
         config=None):
    return cell.run(workload, seed, seconds, traced, "cpu",
                    time.perf_counter(),
                    config=config or small_config(workload))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "import conftest, time\n"
        "from benchlib import cell\n"
        "line = cell.run('ssb_sf20.flight1', 5, 0.2, True, 'cpu',\n"
        "                time.perf_counter(),\n"
        "                config=conftest.small_config('ssb_sf20.flight1'))\n"
        "print(json.dumps([line['correct'],\n"
        "                  sorted({m.split('.')[0] for m in sys.modules})]))\n"
        % (str(BENCH / "tests"), str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, top = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert "supersonic_tpu_torch" in top and "torch" in top
    assert not set(top) & {"jax", "jaxlib", "flax", "supersonic_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    import ast

    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top in {"torch", "numpy", "datetime", "dataclasses",
                               "__future__", "reference"}, (path.name, n)


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ssb_sf20.star",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_run_exits_without_a_result_where_there_is_no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_run_exits_without_a_result_beside_no_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_a_cell_config_and_metric_added_as_files_are_found(tmp_path,
                                                           monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = small_config("ssb_sf20.flight1")
    cfg["name"] = "ssb_tiny"
    (bench / "configs" / "ssb_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "q1_1_only.json").write_text(json.dumps({
        "schema": "ssb", "queries": [json.loads(
            (BENCH / "traffic" / "flight1.json").read_text())["queries"][0]],
        "limits": {"wrong_answers": 0}}))
    (bench / "metrics" / "host.queries.py").write_text(
        "def read(trace):\n    return float(trace.queries)\n")
    manifest["configs"].append({"name": "ssb_tiny", "source": "x",
                                "file": "benchmark/configs/ssb_tiny.json",
                                "reduced": [], "why": "x"})
    manifest["workloads"].append({"name": "ssb_tiny.q1_1_only",
                                  "config": "ssb_tiny",
                                  "traffic": "q1_1_only", "chips": 1,
                                  "why": "x"})
    manifest["per_layer"].append({"name": "host.queries", "unit": "queries",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "entry", "moves": "rows_per_s",
                                  "workloads": ["ssb_tiny.q1_1_only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    monkeypatch.setattr(registry, "BENCH", bench)
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    found = registry.cell("ssb_tiny.q1_1_only")
    assert found.config["name"] == "ssb_tiny"
    assert "host.queries" in {m["name"] for m in found.per_layer}
    assert "host.queries" not in {
        m["name"] for m in registry.cell("ssb_sf20.star").per_layer}
    line = cell.run("ssb_tiny.q1_1_only", 3, 0.3, True, "cpu",
                    time.perf_counter())
    assert line["correct"]
    assert line["metrics"]["host.queries"]["value"] == line["attempted"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    import control

    r = control.readings(workload, 2 ** 31 + 23, 0.3, "cpu",
                         small_config(workload))
    assert r["program_correct"], r
    assert not r["control_correct"], r


def _stale(T, real):
    first = []

    def execute(op, *a, **k):
        if not first:
            first.append(real(op, *a, **k))
        return first[0]
    return execute


def _half_batch(T, real):
    from supersonic_tpu_torch.ops import base

    def execute(op, *a, **k):
        run, _, leaves = base.compile_plan(op)
        big = max(range(len(leaves)), key=lambda i: leaves[i].capacity)
        t = leaves[big]
        half = T.Table(t.schema, t.columns, int(t.num_rows) // 2, t.device,
                       t.dicts)
        half.stats, half.rowid = t.stats, t.rowid
        leaves[big] = half
        table, flags, names = run(base.prepare_leaves(leaves, run.lazy))
        base.finish(run, flags, names)
        return table
    return execute


def _altered(T, real):
    def execute(op, *a, **k):
        table = real(op, *a, **k)
        col = table.columns[table.schema.names()[-1]]
        if col.values.is_floating_point():
            col.values[0] *= 1 + 1e-6
        else:
            col.values[0] += 1
        return table
    return execute


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    import supersonic_tpu_torch as T

    monkeypatch.setattr(T, "execute", fault(T, T.execute))
    line = _run(workload, seconds=0.5)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_small_runs_are_correct_and_report_their_metrics(workload):
    line = _run(workload)
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"rows_per_s", "query_ms_p50",
                                    "query_ms_p95", "setup_s"}
    assert list(line)[-1] == "checks"
    traced = _run(workload, traced=True)
    assert traced["correct"] and "host.bind_ms" in traced["metrics"]
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.card
def test_a_short_traced_run_on_the_card(card):
    line = cell.run("ssb_sf20.flight1", 11, 1.0, True, card,
                    time.perf_counter(),
                    config=small_config("ssb_sf20.flight1"))
    assert line["correct"]
    assert line["device"]["busy_s"] > 0
    assert line["metrics"]["kernels.own_ms"]["value"] > 0
