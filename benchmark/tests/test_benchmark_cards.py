"""Cells on more than one card, on the CPU over gloo at P = 2: a copy of the
benchmark to which a cell on two cards is added as files and entries alone
(``tests/multicard``: a small SSB configuration with ``placement``, a
traffic file, and ``dist_answer`` modules of Q2.1 and Q1.1 whose
references are the existing ``reference/ssb_q2_1.py`` and
``reference/ssb_q1_1.py``), run by the launcher in a process of its own.
Then the faults: a query that raises on one rank, a broken timed path, a
rank that hangs or dies, JAX loaded after the window; and the combining of
the ranks' reports."""
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
from conftest import BENCH

from benchlib import cards, rankrun, traffic

ROOT = BENCH.parent
DATA = BENCH / "tests" / "multicard"
CELL = "ssb_tiny.q2_1_q1_1"
SEED = 2 ** 31 + 29
SECONDS = 0.6
WARM_Q2_1 = 4   # calls of Q2.1 in the warm-up: two rounds of two entries

LAUNCH_SCRIPT = """
import json, sys, time
a = json.loads(sys.argv[1])
sys.path[:0] = [a.pop("bench"), a.pop("root")]
from benchlib import cards, registry
if a.pop("control"):
    import control
    print(json.dumps(control.readings(a["workload"], a["seed"], a["seconds"],
                                      a["device"])))
    sys.exit(0)
a["started"] = time.perf_counter()
try:
    reports = cards.run_ranks(**a)
    line = cards.combine(registry.cell(a["workload"]), reports, a["traced"])
except cards.Failed as e:  # as run.py does
    print(e, file=sys.stderr)
    sys.exit(e.code)
print(json.dumps({"reports": reports, "line": line}))
"""


def checkout(tmp_path, generator="ssb", fault="", chips=2):
    """A copy of the benchmark with the two-card cell added as files and
    entries; ``fault`` is appended to the Q2.1 module, so that it runs in
    every rank."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (root / "supersonic_tpu_torch").symlink_to(ROOT / "supersonic_tpu_torch")
    cfg = json.loads((DATA / "ssb_tiny.json").read_text())
    cfg["generator"] = generator
    (bench / "configs" / "ssb_tiny.json").write_text(json.dumps(cfg))
    shutil.copy(DATA / "ssb_shares.py", bench / "generators")
    shutil.copy(DATA / "q2_1_q1_1.json", bench / "traffic")
    shutil.copy(DATA / "ssb_q1_1.dist.py", bench / "queries")
    (bench / "queries" / "ssb_q2_1.dist.py").write_text(
        (DATA / "ssb_q2_1.dist.py").read_text() + fault)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "ssb_tiny", "source": cfg["source"],
        "file": "benchmark/configs/ssb_tiny.json", "reduced": ["rows"],
        "why": "SSB's star schema, small, with lineorder in shares"})
    manifest["workloads"].append({
        "name": CELL, "config": "ssb_tiny", "traffic": "q2_1_q1_1",
        "chips": chips, "why": "Q2.1 and Q1.1 over lineorder in shares"})
    for m in manifest["per_layer"]:
        if "workloads" in m:  # the program's metrics read the ranks too
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def launch(root, traced=False, control=False, ranks=2, device="cpu",
           timeout=150):
    args = {"bench": str(root / "benchmark"), "root": str(root),
            "workload": CELL, "ranks": ranks, "seed": SEED,
            "seconds": SECONDS, "traced": traced, "device": device,
            "control": control}
    if control:
        del args["ranks"], args["traced"]
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", LAUNCH_SCRIPT, json.dumps(args)], cwd=root,
        capture_output=True, text=True, timeout=timeout)
    out.seconds = time.perf_counter() - t
    return out


def result(out) -> dict:
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def rank_pids(out) -> list:
    return [int(line.rsplit(" ", 1)[1]) for line in out.stderr.splitlines()
            if line.startswith("rank ") and ": pid " in line]


def gone(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return result(launch(checkout(tmp_path_factory.mktemp("plain"))))


def test_a_two_card_cell_added_as_files_runs_correct(plain):
    line = plain["line"]
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["attempted"] > 6
    assert set(line["metrics"]) == {"rows_per_s", "query_ms_p50",
                                    "query_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 2
    assert len(line["device"]["memory_peak_bytes_ranks"]) == 2
    assert list(line)[-1] == "checks"
    first = plain["reports"][0]
    assert len(first["latency_ms"]) == line["attempted"]
    # rows_per_s counts the whole fact table for each correct query
    rows = json.loads((DATA / "ssb_tiny.json").read_text())["rows"]
    rate = line["metrics"]["rows_per_s"]["value"]
    assert rate * sum(first["latency_ms"]) / 1e3 <= (
        rows["lineorder"] * line["attempted"])


def test_every_rank_sees_the_same_stream(plain):
    reports = plain["reports"]
    n = reports[0]["stream"]["queries"]
    assert n == plain["line"]["attempted"]
    stream = traffic.stream(json.loads(
        (DATA / "q2_1_q1_1.json").read_text()), SEED)
    want = cards.rankrun.stream_digest([next(stream).key
                                         for _ in range(n)])
    assert all(rep["stream"] == want for rep in reports)


def test_a_traced_run_of_shares_made_by_the_generator(tmp_path):
    got = result(launch(checkout(tmp_path, generator="ssb_shares"),
                        traced=True))
    line = got["line"]
    assert line["correct"], line["checks"]
    # on the CPU the trace holds no device activity: only the plans' bind
    # time, from the program's spans, has something to read; the binds lie
    # inside the port's distributed calls, out of the benchmark's spans
    assert "entry.bind_ms" in line["metrics"]
    assert "host.bind_ms" not in line["metrics"]
    for name, m in line["metrics"].items():
        assert len(m["ranks"]) == 2, name
        assert m["value"] == max(v for v in m["ranks"] if v is not None)
    dev = line["device"]
    assert dev["busy_s"] == pytest.approx(sum(dev["busy_s_ranks"]) / 2)
    assert dev["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "dispatch" in dict(line["breakdown"]["idle_gaps"])


RAISES_ON_RANK_1 = f"""
_calls = []
_dist_answer = dist_answer


def dist_answer(T, mesh, tables, p):
    out = _dist_answer(T, mesh, tables, p)
    _calls.append(1)
    if mesh.rank == 1 and len(_calls) == {WARM_Q2_1 + 2}:
        raise RuntimeError("a fault planted on rank 1")
    return out
"""


def test_a_query_that_raises_on_one_rank_fails_once(tmp_path):
    line = result(launch(checkout(tmp_path, fault=RAISES_ON_RANK_1)))["line"]
    assert line["failed"] == 1 and line["attempted"] > 3
    assert line["checks"]["failed_queries"]["value"] == 1
    assert not line["correct"]


FAULTS = {
    "state_unchanged": """
import supersonic_tpu_torch as _T
_execute, _first = _T.execute, []


def _stale(op, *a, **k):
    if not _first:
        _first.append(_execute(op, *a, **k))
    return _first[0]


_T.execute = _stale
""",
    "half_batch": """
import supersonic_tpu_torch as _T
import supersonic_tpu_torch.parallel as _par
_dist_map = _par.dist_map


def _half(mesh, fn, t, *rest):
    half = _T.Table(t.schema, t.columns, int(t.num_rows) // 2, t.device,
                    t.dicts)
    half.stats, half.rowid = t.stats, t.rowid
    return _dist_map(mesh, fn, half, *rest)


_par.dist_map = _half
""",
    "exchange_left_out": """
import supersonic_tpu_torch.parallel.dist as _dist
_dist._all_to_all = lambda mesh, x: x
""",
    "answer_altered": """
import supersonic_tpu_torch as _T
_execute = _T.execute


def _altered(op, *a, **k):
    table = _execute(op, *a, **k)
    table.columns[table.schema.names()[-1]].values[0] += 1
    return table


_T.execute = _altered
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    line = result(launch(checkout(tmp_path, fault=FAULTS[fault])))["line"]
    assert not line["correct"], line["checks"]


ENDS = {
    "hangs": "import time\n        time.sleep(3600)",
    "dies": "import os\n        os._exit(9)",
}


@pytest.mark.parametrize("how", sorted(ENDS))
def test_a_rank_that_hangs_or_dies_ends_the_run(tmp_path, how):
    fault = RAISES_ON_RANK_1.replace(
        'raise RuntimeError("a fault planted on rank 1")', ENDS[how])
    out = launch(checkout(tmp_path, fault=fault))
    assert out.returncode == 4 and '"line"' not in out.stdout
    pids = rank_pids(out)
    assert len(pids) == 2 and all(gone(p) for p in pids)
    if how == "hangs":
        # the bound is worked out from the warm-up, never under QUERY_S
        bound = float(re.search(r"gave no word for (\S+) s in window: hung",
                                out.stderr)[1])
        assert bound >= rankrun.QUERY_S
        assert out.seconds < 60 + bound
    else:
        assert "exited with" in out.stderr


# a module that the rank loads after its window; the stub stands in for JAX
# (the check reads names alone), found first on the rank's path
LOADS_JAX_AFTER_THE_WINDOW = {
    "reference": ("reference/ssb_q2_1.py", False),
    "metric": ("metrics/host.syncs.py", True),
}


@pytest.mark.parametrize("where", sorted(LOADS_JAX_AFTER_THE_WINDOW))
def test_jax_loaded_by_a_rank_after_its_window_gives_no_line(tmp_path, where):
    module, traced = LOADS_JAX_AFTER_THE_WINDOW[where]
    root = checkout(tmp_path)
    (root / "benchmark" / "jax.py").write_text('"""A stand-in for JAX."""\n')
    path = root / "benchmark" / module
    path.write_text(path.read_text() + "\nimport jax  # noqa: E402,F401\n")
    out = launch(root, traced=traced)
    assert out.returncode == 3 and '"line"' not in out.stdout
    assert "loaded in a rank: jax" in out.stderr


def test_the_control_of_a_two_card_cell_is_not_correct(tmp_path):
    r = result(launch(checkout(tmp_path), control=True))
    assert r["program_correct"], r
    assert not r["control_correct"], r


def test_the_line_takes_the_worst_rank_and_the_mean_busy_time():
    c = type("Cell", (), {"per_layer": [
        {"name": "a_ms", "unit": "ms", "better": "lower"},
        {"name": "b_pct", "unit": "%", "better": "higher"},
        {"name": "none", "unit": "ms", "better": "lower"}]})()

    def rep(rank, a, b, peak, busy):
        out = {"rank": rank, "stream": {"queries": 3, "digest": "x"},
               "forbidden": [], "busy_s": busy, "window_s": 2.0,
               "device": {"platform": "gpu", "kind": "card",
                          "memory_peak_bytes": peak},
               "metrics": {"a_ms": a, "b_pct": b, "none": None}}
        if rank == 0:
            out.update(correct=True, attempted=3, failed=0, checks={},
                       breakdown={"device_ops": [], "idle_gaps": []})
        return out

    line = cards.combine(c, [rep(0, 1.0, 50.0, 7, 1.0),
                             rep(1, 3.0, 40.0, 9, 1.5),
                             rep(2, None, 45.0, 8, 0.5)], traced=True)
    assert line["metrics"]["a_ms"] == {"value": 3.0, "unit": "ms",
                                       "ranks": [1.0, 3.0, None]}
    assert line["metrics"]["b_pct"]["value"] == 40.0
    assert "none" not in line["metrics"]
    assert line["device"]["count"] == 3
    assert line["device"]["memory_peak_bytes"] == 9
    assert line["device"]["busy_s"] == pytest.approx(1.0)
    assert line["device"]["window_s"] == 2.0


def test_ranks_that_ran_different_streams_or_loaded_jax_give_no_line():
    c = type("Cell", (), {"end_to_end": []})()
    base = {"forbidden": [], "device": {"platform": "gpu", "kind": "card",
                                        "memory_peak_bytes": 1},
            "correct": True, "attempted": 1, "failed": 0, "checks": {},
            "metrics": {}}
    a = dict(base, stream={"queries": 3, "digest": "x"})
    b = dict(base, stream={"queries": 4, "digest": "y"})
    with pytest.raises(cards.Failed) as e:
        cards.combine(c, [a, b], traced=False)
    assert e.value.code == 4
    with pytest.raises(cards.Failed) as e:
        cards.combine(c, [a, dict(a, forbidden=["jax"])], traced=False)
    assert e.value.code == 3 and "jax" in str(e.value)


@pytest.mark.card
def test_the_small_cell_on_four_cards_over_nccl(tmp_path):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    got = result(launch(checkout(tmp_path, chips=4), ranks=4, device="cuda",
                        timeout=1500))
    line = got["line"]
    print(json.dumps({"four_cards": line,
                      "latency_ms": got["reports"][0]["latency_ms"]}))
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
