"""The port's twins of the JAX side's benchmark and example programs, on the
CPU: ``bench/ops.py`` (``bench_ops.py``), ``bench/configs.py``
(``scripts/bench_configs.py``), ``bench/stress_edges.py``
(``scripts/stress_edges.py``), ``examples/operation_example.py``
(``examples/operation_example.py``) and ``bench/dist.py``
(``bench_dist.py``).

The plan builders take the package as a namespace, so the same plans over
the same seeded numpy data run in the JAX package and in the port: every
output column equal in order (integers, keys and floats bit for bit), but
f32 sums, within ``SUM_RTOL`` of max(1, |exact sum|) (the JAX package's
sort-path f32 sums are differences of a running sum over the whole column,
so a small group's error follows the column's total; PARITY.md:217-221),
and the compute expression, within ``TRANSCENDENTAL_RTOL``.  The JAX
package's dense group-bys run its Pallas kernel in interpret mode here
(about 1.7 s a call at these sizes), which the three dense plans afford.
Every port result is also held to numpy by the twins' own checks.  The
exchange analysis is held byte for byte to the repo's ``EXCHANGE.json``,
which the JAX ``bench_dist.py --analyze`` wrote at 1M x 100k.
"""
import contextlib
import io
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import supersonic_tpu as J
import supersonic_tpu_torch as T
from supersonic_tpu_torch.bench import configs as C
from supersonic_tpu_torch.bench import dist as BD
from supersonic_tpu_torch.bench import headline as H
from supersonic_tpu_torch.bench import ops as O
from supersonic_tpu_torch.bench import stress_edges as S
from supersonic_tpu_torch.examples import operation_example as E
from supersonic_tpu_torch.ops import hash_join as TH

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
EXCHANGE = json.loads((REPO / "EXCHANGE.json").read_text())
N, M = 4096, 512                     # bench_ops plans
N10, N100, CM = 4096, 8192, 512      # configs
SUM_COLS = {"sv"}
CLOSE_COLS = {"out"}                 # the compute expression


def assert_same_result(got, want, what):
    """Port result ``got`` against JAX result ``want``: same columns, rows
    and order; f32 sums and the compute expression within their
    tolerances, everything else exact."""
    g, w = O.host_columns(got), O.host_columns(want)
    assert list(g) == list(w), (what, list(g), list(w))
    for name, (gv, gvalid) in g.items():
        wv, wvalid = w[name]
        assert (gvalid is None) == (wvalid is None), (what, name)
        if gvalid is not None:
            assert np.array_equal(gvalid, wvalid), (what, name)
            gv, wv = gv[gvalid], wv[wvalid]
        assert gv.shape == wv.shape, (what, name, gv.shape, wv.shape)
        if name in SUM_COLS:
            err = np.abs(gv.astype(np.float64) - wv)
            assert (err <= O.SUM_RTOL * np.maximum(1.0, np.abs(wv))).all(), \
                (what, name, float(err.max()))
        elif name in CLOSE_COLS:
            np.testing.assert_allclose(gv, wv, rtol=O.TRANSCENDENTAL_RTOL)
        elif gv.dtype == object:
            assert list(gv) == list(wv), (what, name)
        else:
            O.same(gv, wv, f"{what}.{name}")


# ---------------------------------------------------------------------------
# bench/ops.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ops_data():
    return O.build_data(N, M)


@pytest.fixture(scope="module")
def ops_plans(ops_data):
    return (O.build_plans(T, device="cpu", data=ops_data),
            O.build_plans(J, device=None, data=ops_data))


def test_keys_and_labels_are_bench_ops():
    """Letter for letter and in order, as bench_ops.py stores them."""
    src = (REPO / "bench_ops.py").read_text()
    want = re.findall(r'results\["(\w+)"\] = bench\(\s*"([^"]+)"', src)
    assert len(want) == 15
    assert list(O.LABELS) == want


def test_data_is_drawn_in_bench_ops_order(ops_data):
    """The first and last draws of bench_ops.py:68-300's generator."""
    rng = np.random.default_rng(42)
    assert np.array_equal(ops_data["fact"]["fk"],
                          rng.integers(0, M, N).astype(np.int32))
    last = np.random.default_rng(42)
    # every draw before the merge runs' last one (vb), in order
    draws = [("i", M, N), ("f", N), ("i", 64, N), ("i", 64, M), ("f", N),
             ("d", N), ("i", 64, N)] + [("i", 64, M)] * 6 + [
        ("i", 64, M), ("i", M // 8, N), ("f", N), ("i", 64, N),
        ("i", 2 * M, N), ("f", N), ("i", 64, N), ("i", 50, N), ("f", N),
        ("i", 1000, N), ("i2", N), ("d", N), ("i", M, N), ("f", N),
        ("i", 64, M), ("i", 64, N // 2), ("i", 64, N // 2), ("f", N // 2)]
    for d in draws:
        if d[0] == "i":
            last.integers(0, d[1], d[2])
        elif d[0] == "i2":
            last.integers(-50, 51, d[1])
        elif d[0] == "f":
            last.random(d[1], dtype=np.float32)
        else:
            last.random(d[1])
    vb = last.random(N // 2, dtype=np.float32)
    assert np.array_equal(np.sort(ops_data["sorted_b"]["v"]), np.sort(vb))


@pytest.mark.parametrize("key", [k for k, _ in O.LABELS])
def test_bench_ops_plan_matches_jax_and_numpy(key, ops_plans, ops_data):
    (label, plan, rows), (jlabel, jplan, jrows) = (p[key] for p in ops_plans)
    assert (label, rows) == (jlabel, jrows) == (dict(O.LABELS)[key], N)
    got = T.execute(plan)
    O.check(key, got, ops_data)
    assert_same_result(got, J.execute(jplan), key)


def test_join_merge_takes_the_merge_probe(ops_plans, monkeypatch):
    """bench_ops.py:153-160 forces the merge probe; the port must not take
    its row-id probe there, and takes it for the plain join."""
    calls = []
    orig = TH._merge_probe

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(TH, "_merge_probe", counted)
    port = ops_plans[0]
    T.execute(port["join"][1])
    assert calls == []
    T.execute(port["join_merge"][1])
    assert calls == [1]


def test_check_catches_a_wrong_row(ops_plans, ops_data):
    out = T.execute(ops_plans[0]["sort"][1])
    out.columns["fk"].values[7] += 1
    with pytest.raises(O.Mismatch, match="sort.fk"):
        O.check("sort", out, ops_data)


def test_bench_ops_main_times_and_checks_every_plan(capsys):
    res = O.main(N, M, device="cpu")
    assert list(res) == [k for k, _ in O.LABELS]
    assert all(s > 0 for s in res.values())
    err = capsys.readouterr().err.splitlines()
    assert len(err) == len(O.LABELS)
    for ln, (_, label) in zip(err, O.LABELS):
        assert ln.startswith(label + " ") and ln.endswith(" M rows/s"), ln


def test_bench_ops_cli_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert O._cli([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# bench/configs.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def config_runs():
    """{key: (port result, JAX result, data)}."""
    port = list(C.build_configs(T, N10, N100, CM, device="cpu"))
    jax = list(C.build_configs(J, N10, N100, CM, device=None))
    return {p[0]: (T.execute(p[2]), J.execute(j[2]), p[4], p[1], j[1])
            for p, j in zip(port, jax)}


@pytest.mark.parametrize("key", [k for k, _ in C.LABELS])
def test_config_matches_jax_and_numpy(key, config_runs):
    got, want, data, label, jlabel = config_runs[key]
    assert label == jlabel == dict(C.LABELS)[key]
    assert C.check(key, got, data) == int(want.num_rows)
    assert_same_result(got, want, key)


def test_configs_labels_are_bench_configs():
    src = (REPO / "scripts" / "bench_configs.py").read_text()
    assert re.findall(r'bench\("(config[^"]+)"', src) == \
        [lb for _, lb in C.LABELS]


def test_configs_main_prints_first_run_and_timing(capsys):
    res = C.main(N10, N100, CM, device="cpu")
    assert list(res) == [k for k, _ in C.LABELS]
    err = capsys.readouterr().err.splitlines()
    for _, label in C.LABELS:
        assert any(ln.startswith(f"{label}: first run ") for ln in err)
        assert any(ln.startswith(f"{label:<28} ") and "M rows/s" in ln
                   for ln in err)


def test_sort_words_order_rows_as_lexsort():
    k = np.array([3, 1, 3, 0, 3], dtype=np.int32)
    v = np.array([0.25, 0.5, 0.75, 0.0, 0.25], dtype=np.float32)
    order = np.argsort(O.sort_words(k, v), kind="stable")
    assert order.tolist() == np.lexsort((-v, k)).tolist() == [3, 1, 2, 0, 4]


# ---------------------------------------------------------------------------
# bench/stress_edges.py and examples/operation_example.py
# ---------------------------------------------------------------------------

def test_stress_edges_small_against_numpy(capsys):
    assert S._cli(["--small", "--cpu"]) == 0
    out = capsys.readouterr()
    assert out.out.strip() == "stress_edges: all OK"
    lines = out.err.splitlines()
    assert len(lines) == 3 and all(": OK" in ln for ln in lines)
    assert "overflow flag off" in lines[1] and "overflow flag off" in lines[2]


def test_stress_sizes_are_the_scripts():
    assert S.sizes(False) == (17_000_000, 17_000_000, 8_000_000, 100_000)
    assert S.sizes(True) == (300_000, 300_000, 125_000, 1562)
    assert 17_000_000 > 1 << 24


def test_stress_check_refuses_an_overflow_or_a_wrong_row():
    fk = np.array([2, 0, 1], dtype=np.int64)
    pv = np.repeat(np.arange(3), S.DUP)
    cols = {"fk": fk[pv], "pv": pv, "bk": fk[pv],
            "bv": (S.DUP * fk[:, None] + np.arange(S.DUP)).ravel()}
    schema = T.TupleSchema.of(*[(c, T.INT64, False) for c in cols])
    out = T.Table.from_data(schema, cols, device="cpu")
    assert S.check_join(out, fk, {S.OVERFLOW: False}, "ok") == 9
    with pytest.raises(O.Mismatch, match="overflow flag True"):
        S.check_join(out, fk, {S.OVERFLOW: True}, "full")
    cols["bv"] = cols["bv"][::-1].copy()
    bad = T.Table.from_data(schema, cols, device="cpu")
    with pytest.raises(O.Mismatch, match="bv"):
        S.check_join(bad, fk, {S.OVERFLOW: False}, "order")


def test_operation_example_against_numpy(tmp_path, capsys):
    stats = E.main(3000, str(tmp_path), device="cpu")
    assert list(stats) == list(E.NAMES)
    rows = {k: s.rows_processed for k, s in stats.items()}
    assert rows == {"group": 50, "compute": 3000, "sort": 3000,
                    "union": 6000, "join": 3000}
    for name in E.NAMES:
        dot = (tmp_path / f"{name}.dot").read_text()
        assert dot.startswith(f'digraph "{name}"')
    assert "=== join ===" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# bench/dist.py
# ---------------------------------------------------------------------------

EXCHANGES = ("fact_shuffle_by_fk", "dim_shuffle_by_pk",
             "groupby_pregroup_shuffle", "ring_build_rotation")
FIELDS = ("rows", "row_bytes", "total_bytes", "offmesh_bytes")


@pytest.fixture(scope="module")
def analysis(tmp_path_factory):
    """``bench_dist.py --analyze`` at 1M x 100k over gloo, P = 1, 2, 4:
    (result, written record, stdout)."""
    out = tmp_path_factory.mktemp("dist") / "exchange.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = BD.analyze(EXCHANGE["fact_rows"], EXCHANGE["dim_rows"], 4,
                         "cpu", reps=1, out=str(out), threads=1)
    return res, json.loads(out.read_text()), buf.getvalue()


@pytest.mark.parametrize("P", [1, 2, 4])
def test_exchange_analysis_equals_the_record(P, analysis):
    """bench_dist.py --analyze's record, byte for byte."""
    res, written, _ = analysis
    want = EXCHANGE["per_P"][str(P)]
    for name in EXCHANGES:
        for f in FIELDS:
            assert res["per_P"][str(P)][name][f] == want[name][f], (name, f)
    assert written["per_P"][str(P)] == res["per_P"][str(P)]
    assert set(res["times"][P]) == set(BD.COMPONENTS)


def test_analysis_record_and_json_line(analysis):
    res, written, printed = analysis
    assert (written["fact_rows"], written["dim_rows"]) == (
        EXCHANGE["fact_rows"], EXCHANGE["dim_rows"])
    assert list(written["per_P"]) == ["1", "2", "4"]
    line = json.loads(printed.strip().splitlines()[-1])
    assert line == res["record"]
    assert line["metric"] == "dist_component_analysis"
    assert line["unit"].startswith("ring/repartition join time ratio at P "
                                   "= 4")


def _local_rows(n_rows, n_dim):
    fact, dim = H.build_data(n_rows, n_dim)
    return T.execute(BD.local_plan(T, *H.build_tables(T, fact, dim, "cpu"))
                     ).to_pylist()


def _same_groups(got, want):
    assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        assert abs(a - b) <= O.SUM_RTOL * max(1.0, abs(b))


def test_run_rows_equal_the_single_process_plan(capsys):
    n, m = 300_000, 30_000
    res = BD.run(n, m, 2, "cpu", reps=1, threads=1)
    want = _local_rows(n, m)
    assert len(want) == H.GROUPS
    for P in (1, 2):
        _same_groups(res["per_P"][P]["rows"], want)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "dist_pipeline_scaling_efficiency"
    assert rec["value"] == res["record"]["value"] > 0


def test_a_group_of_one_runs_in_place_and_leaves_efficiency_undefined(
        tmp_path, capsys):
    """In a process group of one (as on a card), run and analyze work in
    it; the efficiency is null, not 1.0; P = 1's exchanges are the
    record's."""
    import torch.distributed as dist
    from supersonic_tpu_torch.parallel import multihost

    n, m = 200_000, 20_000
    multihost.initialize(f"localhost:{multihost.free_port()}", 1, 0,
                         device="cpu")
    try:
        res = BD.run(n, m, 1, "cpu", reps=1)
        with pytest.raises(ValueError, match="group of 2 ranks"):
            BD.on_ranks(2, BD.run_rank, (n, m), "cpu")
        ana = BD.analyze(n, m, 1, "cpu", reps=1,
                         out=str(tmp_path / "ex.json"))
    finally:
        dist.destroy_process_group()
    assert res["record"]["value"] is None
    assert res["record"]["vs_baseline"] is None
    assert list(res["per_P"]) == [1]
    _same_groups(res["per_P"][1]["rows"], _local_rows(n, m))
    assert list(ana["per_P"]) == ["1"]
    ex = ana["per_P"]["1"]
    assert ex["ring_build_rotation"]["rows"] == 0
    assert ex["dim_shuffle_by_pk"] == {"total_bytes": 8 * m,
                                       "offmesh_bytes": 0, "row_bytes": 8,
                                       "rows": m}
    assert "undefined at one rank" in capsys.readouterr().err
