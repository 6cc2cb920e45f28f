"""The harness's own arithmetic on the CPU: the generators, the window's
rate and percentiles, the traffic streams, the comparison, and the
reduction of a profiler trace."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
from conftest import SMALL_ROWS

from benchlib import compare, registry, stats, trace, traffic
from reference.common import Answer


@pytest.mark.parametrize("schema", ["ssb", "tpch"])
def test_generator_repeats_for_a_seed_and_differs_across_seeds(schema):
    gen = registry.load_module("generators", schema)
    cfg = {"rows": SMALL_ROWS[schema]}
    a, b = gen.generate(cfg, 2 ** 31 + 5, "cpu"), gen.generate(
        cfg, 2 ** 31 + 5, "cpu")
    c = gen.generate(cfg, 2 ** 31 + 6, "cpu")
    fact = a["fact"]
    for col, arr in a["tables"][fact].items():
        assert np.array_equal(arr, b["tables"][fact][col]), col
        assert len(arr) == SMALL_ROWS[schema][fact]
    assert any(not np.array_equal(arr, c["tables"][fact][col])
               for col, arr in a["tables"][fact].items())
    assert a["words"] == c["words"]


def test_ssb_keys_and_values_follow_dbgen():
    gen = registry.load_module("generators", "ssb")
    d = gen.generate({"rows": SMALL_ROWS["ssb"]}, 3, "cpu")["tables"]
    lo, rows = d["lineorder"], SMALL_ROWS["ssb"]
    assert lo["lo_custkey"].min() >= 1
    assert lo["lo_custkey"].max() <= rows["customer"]
    assert not np.any(lo["lo_custkey"] % 3 == 0)
    assert set(np.unique(lo["lo_orderdate"])) <= set(d["date"]["d_datekey"])
    assert lo["lo_quantity"].min() == 1 and lo["lo_quantity"].max() == 50
    assert np.array_equal(lo["lo_revenue"], lo["lo_extendedprice"]
                          * (100 - lo["lo_discount"]) // 100)


def test_tpch_flags_follow_the_dates():
    gen = registry.load_module("generators", "tpch")
    li = gen.generate({"rows": SMALL_ROWS["tpch"]}, 3, "cpu")["tables"][
        "lineitem"]
    late = li["l_shipdate"] > gen.CURRENT
    assert np.array_equal(li["l_linestatus"] == 1, late)
    assert np.all(li["l_returnflag"][late] == 1)   # N: not yet received
    assert set(np.unique(li["l_discount"] * 100).round()) == set(range(11))


def test_rate_is_over_all_rows_and_all_seconds():
    m = stats.window_metrics([0.1, 0.2, 0.3, 0.4], 400, 2.0)
    assert m["rows_per_s"] == 200.0
    assert m["query_ms_p50"] == pytest.approx(250.0)


def test_p95_moves_when_one_query_stalls():
    lat = [0.010] * 100
    before = stats.window_metrics(lat, 100, 1.0)["query_ms_p95"]
    stalled = stats.window_metrics(lat[:99] + [1.0], 100, 1.0)
    assert stalled["query_ms_p95"] == pytest.approx(before)
    five = stats.window_metrics(lat[:94] + [1.0] * 6, 100, 1.0)
    assert five["query_ms_p95"] > 10 * before
    assert stats.percentile([1.0, 2.0, math.inf], 95) == math.inf
    assert stats.percentile(list(range(101)), 95) == 95


def test_stream_repeats_and_shuffles_whole_rounds():
    t = registry.load_json("traffic", "star")
    a = [i.query for _, i in zip(range(30), traffic.stream(t, 9))]
    b = [i.query for _, i in zip(range(30), traffic.stream(t, 9))]
    c = [i.query for _, i in zip(range(30), traffic.stream(t, 10))]
    assert a == b and a != c
    for k in range(3):
        assert sorted(a[10 * k:10 * k + 10]) == sorted(
            q["query"] for q in t["queries"])


def test_parameters_are_drawn_within_their_ranges():
    t = registry.load_json("traffic", "q6")
    seen = [i.params for _, i in zip(range(200), traffic.stream(t, 4))]
    assert {p["year"] for p in seen} == set(range(1993, 1998))
    assert {p["quantity"] for p in seen} == {24, 25}
    assert {p["discount"] for p in seen} <= set(
        t["queries"][0]["params"]["discount"]["choice"])


def _answer():
    return Answer({"k": np.array(["a", "b", "c"], dtype=object),
                   "s": np.array([3, 2, 2]), "f": np.array([1.0, 2.0, 3.0])},
                  keys=["k"], approx=["f"], order=[("s", False)])


def test_compare_takes_ties_in_any_order_and_rows_by_key():
    want = _answer()
    names = ["k", "s", "f"]
    got = {"k": np.array(["a", "c", "b"], dtype=object),
           "s": np.array([3, 2, 2]), "f": np.array([1.0, 3.0, 2.0 + 2e-12])}
    ok, rel = compare.compare(names, got, want)
    assert ok and rel == pytest.approx(1e-12)


@pytest.mark.parametrize("fault", ["order", "value", "rows", "names"])
def test_compare_finds_each_fault(fault):
    want = _answer()
    names = ["k", "s", "f"]
    got = {c: v.copy() for c, v in want.columns.items()}
    if fault == "order":
        got = {c: v[::-1].copy() for c, v in got.items()}
    elif fault == "value":
        got["s"][1] = 5
    elif fault == "rows":
        got = {c: v[:2] for c, v in got.items()}
    else:
        names = ["k", "f", "s"]
    ok, _ = compare.compare(names, got, want)
    assert not ok


def test_checks_hold_each_number_to_its_limit():
    out = compare.checks([(False, True, 1e-14), (False, True, 3e-13)],
                         {"wrong_answers": 0, "max_rel_err": 1e-12})
    assert compare.passed(out)
    assert out["max_rel_err"]["value"] == 3e-13
    assert not compare.passed(compare.checks([(True, False, math.inf)], {}))


class _Event:
    def __init__(self, name, kind, start, dur, cpu=False):
        import torch

        self._n, self._k, self._s, self._d = name, kind, start, dur
        self._dev = (torch.autograd.DeviceType.CPU if cpu
                     else torch.autograd.DeviceType.CUDA)

    def name(self):
        return self._n

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._k.endswith("user_annotation")


def test_trace_reduces_busy_idle_and_own_kernels():
    own = {"seg_kernel"}
    events = [
        _Event("bench.bind", "user_annotation", 0, 100, cpu=True),
        _Event("bench.run", "user_annotation", 100, 400, cpu=True),
        _Event("bench.copy", "user_annotation", 500, 100, cpu=True),
        _Event("void (anonymous namespace)::seg_kernel<4>(SegArgs, int)",
               "kernel", 150, 100),
        _Event("void at::native::vectorized_elementwise_kernel<4>(int)",
               "kernel", 200, 100),
        _Event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 520, 30),
        _Event("Memset (Device)", "gpu_memset", 700, 10),
        _Event("bench.run", "gpu_user_annotation", 100, 400),
        _Event("bench.copy", "kernel", 500, 100),
        _Event("aten::add", "cpu_op", 150, 10, cpu=True),
    ]
    tr = trace.reduce(events, own, 1, {"bind": 1e-4})
    assert tr.window_s == pytest.approx(600e-9)
    assert tr.busy_s == pytest.approx(180e-9)
    assert tr.idle_s["bind"] == pytest.approx(100e-9)
    assert tr.idle_s["run"] == pytest.approx(250e-9)
    assert tr.idle_s["copy"] == pytest.approx(70e-9)
    assert tr.idle_s["harness"] == pytest.approx(0)
    assert tr.device_ms(("kernel",), own=True) == pytest.approx(1e-4)
    assert tr.count("memcpy", "DtoH") == 1
    metrics = {name: registry.load_module("metrics", name).read(tr)
               for name in ("host.syncs", "ops.launches", "kernels.own_ms",
                            "ops.lib_kernel_ms", "device.idle_pct",
                            "host.bind_ms")}
    assert metrics["ops.launches"] == 2 and metrics["host.syncs"] == 1
    assert metrics["ops.lib_kernel_ms"] == pytest.approx(1.4e-4)
    assert metrics["device.idle_pct"] == pytest.approx(70.0)
    assert metrics["host.bind_ms"] == pytest.approx(0.1)
    b = trace.breakdown(tr)
    assert b["idle_gaps"][0][0] == "run" and len(b["device_ops"]) == 4


def test_own_kernel_names_are_read_from_the_program():
    import supersonic_tpu_torch
    import pathlib

    names = trace.own_kernel_names(
        pathlib.Path(supersonic_tpu_torch.__file__).parent)
    assert {"compact_kernel", "seg_kernel", "merge_kernel"} <= names
    assert not trace.is_own_kernel(
        "void at::native::compact_kernel<4>(int)", names)
    assert trace.is_own_kernel(
        "void (anonymous namespace)::compact_kernel<true, true>(unsigned "
        "char const*)", names)


def test_metrics_without_a_trace_return_nothing():
    empty = SimpleNamespace(queries=0, window_s=0.0, device=[], host_s={})
    for name in ("host.syncs", "ops.launches", "kernels.own_ms",
                 "ops.lib_kernel_ms", "device.idle_pct", "host.bind_ms"):
        assert registry.load_module("metrics", name).read(empty) is None
