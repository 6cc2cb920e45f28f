"""The readers of the program's own spans (``benchlib.program`` and the
metrics on it): idle charged to the innermost open span, an operator
node's own device time, nothing read where the program records nothing;
and, on a card, every host sync of every query inside a ``sync.*`` span."""
import collections
import sys
import time
import warnings
from types import SimpleNamespace

import pytest
from conftest import CELLS, small_config

from benchlib import cell, program, registry, traffic

METRICS = ("entry.bind_ms", "entry.syncs", "ops.join_ms", "ops.aggregate_ms",
           "ops.expr_ms", "ops.glue_idle_ms")


def _span(name, start, end, parent, attrs=None, ms=None):
    return (name, start, end, parent, 1, attrs or {}, ms)


def _window():
    """A query of two operator runs over a device busy 150-250, 300-350
    and 420-440 ns: (spans, device records)."""
    spans = [
        _span("query.bind", 0, 100, -1),
        _span("op.HashJoin.bind", 10, 90, 0),
        _span("query.run", 100, 400, -1),
        _span("op.GroupAggregate.run", 110, 390, 2,
              {"name": "GroupAggregate", "route": "sort"}, 0.25),
        _span("op.HashJoin.run", 120, 280, 3,
              {"name": "HashJoin", "route": "fat_lut"}, 0.125),
        _span("kernel.lut_gather", 130, 140, 4),
        _span("query.copy", 400, 450, -1),
        _span("sync.copy.values", 410, 445, 6, {"transfers": 1}),
    ]
    device = [("k", "kernel", 150, 100, False),
              ("k", "kernel", 300, 50, False),
              ("Memcpy DtoH", "memcpy", 420, 20, False)]
    return spans, device


def test_idle_is_charged_to_the_innermost_open_span():
    spans, device = _window()
    v = program.build(spans, device)
    assert v.idle_ns == [100, 80, 150, 130, 60, 10, 30, 15]
    # own idle: a span's idle less its children's
    assert v.own_idle_ns == [20, 80, 20, 70, 50, 10, 15, 15]
    assert sum(v.own_idle_ns) == sum(v.idle_ns[i] for i in (0, 2, 6))
    assert v.top("query.run") == [2] and v.top("op.HashJoin.run") == []


def test_an_operator_nodes_own_device_time_leaves_out_the_nodes_it_runs():
    v = program.build(*_window())
    assert v.own_device_ms[3] == pytest.approx(0.125)
    assert v.own_device_ms[4] == pytest.approx(0.125)
    assert v.own_device_ms[0] is None and v.own_device_ms[5] is None
    assert v.node_ms(program.AGGREGATES) == pytest.approx(0.125)
    assert not v.has_node(program.EXPRESSIONS)


def test_metrics_read_the_programs_spans():
    spans, device = _window()
    tr = SimpleNamespace(queries=1, window_s=450e-9, device=device,
                         host_s={}, _program=program.build(spans, device))
    got = {m: registry.load_module("metrics", m).read(tr) for m in METRICS}
    assert got["entry.bind_ms"] == pytest.approx(100e-6)
    assert got["entry.syncs"] == 1
    assert got["ops.join_ms"] == pytest.approx(0.125)
    assert got["ops.aggregate_ms"] == pytest.approx(0.125)
    assert got["ops.expr_ms"] is None
    # the operator runs' and the kernel wrapper's own idle: 70 + 50 + 10 ns
    assert got["ops.glue_idle_ms"] == pytest.approx(130e-6)


def test_metrics_return_nothing_without_the_programs_recorder(monkeypatch):
    monkeypatch.delitem(sys.modules, program.RECORDER, raising=False)
    spans, device = _window()
    tr = SimpleNamespace(queries=1, window_s=1.0, device=device, host_s={})
    for m in METRICS:
        assert registry.load_module("metrics", m).read(tr) is None
    empty = SimpleNamespace(queries=0, window_s=0.0, device=[], host_s={})
    for m in METRICS:
        assert registry.load_module("metrics", m).read(empty) is None


def test_a_traced_cpu_run_takes_the_programs_spans_once():
    from supersonic_tpu_torch import tracing

    line = cell.run("tpch_sf30.q6", 3, 0.3, True, "cpu", time.perf_counter(),
                    config=small_config("tpch_sf30.q6"))
    assert line["correct"]
    # a host number is read on the CPU; device numbers need a card
    assert line["metrics"]["entry.bind_ms"]["value"] > 0
    assert "ops.expr_ms" not in line["metrics"]
    assert tracing.spans() == []


def _cell_queries(workload):
    """Each query of ``workload``'s traffic once, with drawn parameters."""
    t = registry.cell(workload).traffic
    return [next(traffic.stream({"queries": [q]}, 5)) for q in t["queries"]]


@pytest.mark.card
def test_every_sync_of_every_query_lies_in_a_sync_span(card):
    """Under ``set_sync_debug_mode("warn")`` each host sync warns; the
    innermost span open at that moment must be a ``sync.*`` span."""
    import torch

    import supersonic_tpu_torch as T
    from supersonic_tpu_torch import tracing

    outside = []

    def hook(message, category, filename, lineno, file=None, line=None):
        s = tracing.current()
        if s is None or not s.name.startswith("sync."):
            outside.append((None if s is None else s.name,
                            f"{filename}:{lineno}", str(message)[:80]))

    for workload in CELLS:
        cfg = small_config(workload)
        data = registry.load_module("generators", cfg["generator"]).generate(
            cfg, 5, card)
        prog = cell.Program(T, cell.build_tables(T, data, card),
                            [q["query"] for q in
                             registry.cell(workload).traffic["queries"]])
        queries = _cell_queries(workload)
        for inst in queries:   # builds the kernels, outside the check
            prog.answer(inst)
        torch.cuda.synchronize()
        tracing.start()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = hook
                for inst in queries:
                    prog.answer_traced(inst)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            tracing.stop()
        syncs = sum(s.attrs.get("transfers", 0) for s in tracing.spans()
                    if s.name.startswith("sync."))
        tracing.clear()
        assert syncs >= 2 * len(queries), workload
    assert not outside, collections.Counter(outside).most_common()
