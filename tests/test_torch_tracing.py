"""The port's spans and counters (``supersonic_tpu_torch/tracing.py``) on
the CPU: nothing is recorded, and no span is opened, outside a profiler
window or ``start()``/``stop()``; inside one, the spans of a star-join
plan and of a TPC-H Q1-shaped plan nest as the bound plan does, every span
closes inside its parent, one query's spans share its id, own times add up
to ``query.run``, and each operator run names its class and the route its
bind chose.  The kernel launch counters are the same dict as before."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import supersonic_tpu_torch as T
from supersonic_tpu_torch import kernels, tracing
from supersonic_tpu_torch.ops.base import compile_plan, finish, \
    prepare_leaves

torch.set_num_threads(1)

RNG = np.random.default_rng(17)
FACT = T.Table.from_data(T.TupleSchema.of(
    ("fk", T.INT32, False), ("dk", T.INT32, False), ("v", T.INT64, False),
    ("q", T.DOUBLE, False)), {
    "fk": RNG.integers(0, 500, 4000, dtype=np.int32),
    "dk": RNG.integers(0, 40, 4000, dtype=np.int32) * 3,
    "v": RNG.integers(0, 1000, 4000, dtype=np.int64),
    "q": RNG.random(4000)}, device="cpu")
DIM = T.Table.from_data(T.TupleSchema.of(
    ("pk", T.INT32, False), ("g", T.INT32, False)), {
    "pk": np.arange(500, dtype=np.int32),
    "g": RNG.integers(0, 8, 500, dtype=np.int32)}, device="cpu")
SPARSE = T.Table.from_data(T.TupleSchema.of(
    ("sk", T.INT32, False), ("h", T.INT32, False)), {
    "sk": np.arange(0, 120, 3, dtype=np.int32)[::-1].copy(),
    "h": RNG.integers(0, 5, 40, dtype=np.int32)}, device="cpu")
LINES_Q = RNG.random(3000)
LINES = T.Table.from_data(T.TupleSchema.of(
    ("g", T.INT32, False), ("q", T.DOUBLE, False)), {
    "g": RNG.integers(0, 4, 3000, dtype=np.int32), "q": LINES_Q},
    device="cpu")


def star():
    """Filter -> two UNIQUE joins -> GroupAggregate -> Sort (SSB's shape),
    and the tree of operator runs its bind gives (the fact's Filter fuses
    into the first join; the second dimension's binds as a node)."""
    fact = T.Filter(T.col("v") > T.Const(100, T.INT64), T.ScanTable(FACT))
    j1 = T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"], fact,
                    T.ScanTable(DIM), T.KeyUniqueness.UNIQUE,
                    lhs_projector=T.Projector.named("dk", "v"),
                    rhs_projector=T.Projector.named("g"))
    dim = T.Filter(T.col("h") < T.Const(4, T.INT32), T.ScanTable(SPARSE))
    j2 = T.HashJoin(T.JoinType.INNER, ["dk"], ["sk"], j1, dim,
                    T.KeyUniqueness.UNIQUE,
                    lhs_projector=T.Projector.named("v", "g"),
                    rhs_projector=T.Projector.named("h"))
    agg = T.GroupAggregate(
        ["g", "h"], [T.AggSpec(T.Aggregation.SUM, "v", "s",
                               output_type=T.INT64)], j2,
        T.GroupAggregateOptions(estimated_result_row_count=64))
    plan = T.Sort([T.SortKey("g"), T.SortKey("h")], agg)
    tree = ("Sort", [("GroupAggregate", [("HashJoin", [
        ("HashJoin", [("ScanTable", []), ("ScanTable", [])]),
        ("Filter", [("ScanTable", [])])])])])
    return plan, tree


def q1():
    """Filter -> Compute -> GroupAggregate -> Compute -> Sort (Q1's shape)."""
    c, one = T.col, T.Const(1.0, T.DOUBLE)
    rows = T.Compute([c("g"), (c("q") * (one - c("q"))).as_("d")],
                     T.Filter(c("q") <= T.Const(0.9, T.DOUBLE),
                              T.ScanTable(LINES)))
    agg = T.GroupAggregate(
        ["g"], [T.AggSpec(T.Aggregation.SUM, "d", "sd"),
                T.AggSpec(T.Aggregation.COUNT, None, "n",
                          output_type=T.INT64)], rows,
        T.GroupAggregateOptions(estimated_result_row_count=6))
    out = T.Compute([c("g"), (c("sd") / c("n")).as_("avg")], agg)
    plan = T.Sort([T.SortKey("g")], out)
    tree = ("Sort", [("Compute", [("GroupAggregate", [("Compute", [
        ("Filter", [("ScanTable", [])])])])])])
    return plan, tree


def run_query(plan):
    """``execute``'s four calls, then the copy to the host."""
    run, _bound, leaves = compile_plan(plan)
    table, flags, names = run(prepare_leaves(leaves, run.lazy))
    finish(run, flags, names)
    return table.to_numpy()


def run_tree(spans, index):
    """The tree of operator runs under span ``index``."""
    kids = [i for i, s in enumerate(spans)
            if s.parent == index and s.name.startswith("op.")
            and s.name.endswith(".run")]
    return [(spans[i].attrs["name"], run_tree(spans, i)) for i in kids]


@pytest.fixture
def recorded():
    tracing.clear()
    yield
    tracing.stop()
    tracing.clear()


def test_nothing_is_recorded_or_opened_outside_a_window(recorded,
                                                        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was opened")

    monkeypatch.setattr(tracing, "_Open", refuse)
    assert not tracing.active()
    for make in (star, q1):
        run_query(make()[0])
    assert tracing.spans() == [] and tracing.current() is None


@pytest.mark.parametrize("window", ["profiler", "start"])
@pytest.mark.parametrize("make", [star, q1], ids=["star", "q1"])
def test_spans_nest_as_the_bound_plan(recorded, window, make):
    plan, tree = make()
    if window == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            assert tracing.active()
            run_query(plan)
            run_query(make()[0])
    else:
        tracing.start()
        run_query(plan)
        run_query(make()[0])
        tracing.stop()
    assert not tracing.active()
    spans = tracing.spans()
    tops = [(s.name, s.query) for s in spans if s.parent < 0]
    phases = ["query.bind", "query.prepare", "query.run", "query.finish",
              "query.copy"]
    assert [n for n, _ in tops] == phases * 2
    assert [q for _, q in tops] == [tops[0][1]] * 5 + [tops[5][1]] * 5
    assert tops[5][1] > tops[0][1]
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.query == p.query
    for i, s in enumerate(spans):
        if s.name == "query.run":
            assert run_tree(spans, i) == [tree]
    binds = [s.name for s in spans if s.name.endswith(".bind")
             and s.name.startswith("op.")]
    assert binds.count("op.ScanTable.bind") == 2 * str(tree).count(
        "ScanTable")


def test_own_times_add_up_to_the_run(recorded):
    tracing.start()
    run_query(star()[0])
    tracing.stop()
    spans = tracing.spans()
    run = next(i for i, s in enumerate(spans) if s.name == "query.run")

    def inside(i):
        return i == run or (i >= 0 and inside(spans[i].parent))

    own = {i: s.end_ns - s.start_ns for i, s in enumerate(spans)}
    for s in spans:
        if s.parent >= 0:
            own[s.parent] -= s.end_ns - s.start_ns
    assert all(v >= 0 for v in own.values())
    assert sum(v for i, v in own.items() if inside(i)) == (
        spans[run].end_ns - spans[run].start_ns)


def test_operator_runs_name_their_class_and_route(recorded):
    tracing.start()
    run_query(star()[0])
    tracing.stop()
    runs = {(s.attrs["name"], s.attrs["route"]) for s in tracing.spans()
            if s.name.startswith("op.") and s.name.endswith(".run")}
    # the first dimension's key is its row id; the filtered sparse keys
    # take the fat LUT; the INT64 SUM over the planned (g, h) domain takes
    # the dense path (the kernel's 64-bit sum words)
    assert runs == {("Sort", None), ("GroupAggregate", "dense"),
                    ("HashJoin", "rowid"), ("HashJoin", "fat_lut"),
                    ("Filter", None), ("ScanTable", None)}


@pytest.mark.parametrize("uniq, dense, route", [
    ("UNIQUE", False, "merge"), ("NOT_UNIQUE", True, "csr"),
    ("NOT_UNIQUE", False, "merge"), ("UNIQUE", True, "fat_lut")])
def test_each_join_route_is_named(recorded, uniq, dense, route):
    plan = T.HashJoin(T.JoinType.INNER, ["dk"], ["sk"], T.ScanTable(FACT),
                      T.ScanTable(SPARSE), getattr(T.KeyUniqueness, uniq),
                      allow_dense_lookup=dense)
    tracing.start()
    run_query(plan)
    tracing.stop()
    (join,) = [s for s in tracing.spans() if s.name == "op.HashJoin.run"]
    assert join.attrs == {"name": "HashJoin", "route": route}


@pytest.mark.parametrize("key, route", [("g", "dense"), ("q", "sort")])
def test_group_by_routes_are_named(recorded, key, route):
    """A COUNT into a small INT32 key domain takes the dense path, a DOUBLE
    key the sort path."""
    plan = T.GroupAggregate([key], [T.AggSpec(T.Aggregation.COUNT, None, "n",
                                              output_type=T.INT64)],
                            T.ScanTable(DIM if key == "g" else FACT))
    tracing.start()
    run_query(plan)
    tracing.stop()
    (agg,) = [s for s in tracing.spans()
              if s.name == "op.GroupAggregate.run"]
    assert agg.attrs["route"] == route


def test_syncs_are_named_and_transfer_nothing_on_the_cpu(recorded):
    tracing.start()
    cols = run_query(q1()[0])
    tracing.stop()
    spans = tracing.spans()
    syncs = [s for s in spans if s.name.startswith("sync.")]
    names = [s.name for s in syncs]
    # g loses its statistics in the Compute, so the group-by takes the sort
    # path over the Filter's device count and reads it once; avg = sd / n
    # is nullable: its validity is copied too
    assert names == (["sync.agg.num_rows", "sync.flags", "sync.copy.num_rows"]
                     + ["sync.copy.values"] * len(cols) + ["sync.copy.valid"])
    assert syncs[0].attrs == {"transfers": 0, "capacity": 3000,
                              "rows": int((LINES_Q <= 0.9).sum())}
    assert all(s.attrs == {"transfers": 0} for s in syncs[1:])
    assert spans[syncs[0].parent].name == "op.GroupAggregate.run"
    assert all(spans[s.parent].name in ("query.finish", "query.copy")
               for s in syncs[1:])


def _reads(plan, site="agg.num_rows"):
    """The ``sync.<site>`` spans of one query of ``plan``, each with its
    parent span's name."""
    tracing.clear()
    tracing.start()
    run_query(plan)
    tracing.stop()
    spans = tracing.spans()
    return [(s.attrs, spans[s.parent].name) for s in spans
            if s.name == f"sync.{site}"]


@pytest.mark.parametrize("child", ["keep_filter", "keep_join", "count"])
def test_a_sort_path_group_by_reads_its_live_rows_once(recorded, child):
    """Over a keep mask (a fused Filter, a masked UNIQUE join) or a device
    row count (a Compute over a Filter), a sort-path group-by with a base
    pass, a MIN pass and a DISTINCT pass reads its live count once, inside
    its own run."""
    A, c = T.Aggregation, T.col
    fact = T.ScanTable(FACT)
    keep = FACT.to_numpy()["v"] > 300
    if child == "keep_join":
        # the dimension keeps its rows of g < 5 (pk = row), probed by fk
        dim = T.Filter(c("g") < T.Const(5, T.INT32), T.ScanTable(DIM))
        node = T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"], fact, dim,
                          T.KeyUniqueness.UNIQUE,
                          lhs_projector=T.Projector.named("q", "v"),
                          rhs_projector=T.Projector.named("g"))
        keep = DIM.to_numpy()["g"][FACT.to_numpy()["fk"]] < 5
    else:
        node = T.Filter(c("v") > T.Const(300, T.INT64), fact)
        if child == "count":
            node = T.Compute([c("q"), c("v")], node)
    plan = T.GroupAggregate(
        ["q"], [T.AggSpec(A.SUM, "v", "s", output_type=T.INT64),
                T.AggSpec(A.MIN, "v", "mn"),
                T.AggSpec(A.SUM, "v", "ds", output_type=T.INT64,
                          distinct=True)], node)
    assert _reads(plan) == [({"transfers": 0, "capacity": 4000,
                                  "rows": int(keep.sum())},
                                 "op.GroupAggregate.run")]


def test_a_group_by_over_host_rows_reads_nothing(recorded):
    """A sort-path group-by over a table built on the host (its row count
    a host int, no keep mask) opens no ``sync.agg.num_rows`` span."""
    A = T.Aggregation
    plan = T.GroupAggregate(["q"], [T.AggSpec(A.MIN, "v", "mn"),
                                    T.AggSpec(A.COUNT, "v", "dc",
                                              distinct=True)],
                            T.ScanTable(FACT))
    assert _reads(plan) == []


def _two_joins(consumer):
    """FACT's rows of v > 100 (the Filter fused) joined with DIM (row-id
    probe), then with SPARSE's rows of h < 4 (fat LUT), under
    ``consumer``: a Compute and a ScalarAggregate (both joins compact), or
    a group-by or a Sort (the second binds masked); and the rows each join
    keeps."""
    A, c = T.Aggregation, T.col
    j1 = T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"],
                    T.Filter(c("v") > T.Const(100, T.INT64),
                             T.ScanTable(FACT)),
                    T.ScanTable(DIM), T.KeyUniqueness.UNIQUE,
                    lhs_projector=T.Projector.named("dk", "q", "v"),
                    rhs_projector=T.Projector.named("g"))
    j2 = T.HashJoin(T.JoinType.INNER, ["dk"], ["sk"], j1,
                    T.Filter(c("h") < T.Const(4, T.INT32),
                             T.ScanTable(SPARSE)), T.KeyUniqueness.UNIQUE,
                    lhs_projector=T.Projector.named("q", "v", "g"),
                    rhs_projector=T.Projector.named("h"))
    if consumer == "Sort":
        plan = T.Sort([T.SortKey("q")], j2)
    elif consumer == "GroupAggregate":
        plan = T.GroupAggregate(["q"], [T.AggSpec(A.MIN, "v", "mn")], j2)
    else:
        plan = T.ScalarAggregate(
            [T.AggSpec(A.SUM, "x", "s", output_type=T.INT64)],
            T.Compute([(c("v") * c("g")).as_("x")], j2))
    f, s = FACT.to_numpy(), SPARSE.to_numpy()
    kept = f["v"] > 100
    dk = set(s["sk"][s["h"] < 4].tolist())
    return plan, [int(kept.sum()),
                  sum(k in dk for k in f["dk"][kept].tolist())]


@pytest.mark.parametrize("consumer",
                         ["ScalarAggregate", "GroupAggregate", "Sort"])
def test_each_compacting_join_reads_its_survivors_once(recorded, consumer):
    """A join that compacts its output reads its count once, inside its
    own run, with the rows it kept and the lhs capacity it compacted (the
    second join's lhs is the first's survivors); a join bound masked under
    a group-by or a Sort reads nothing."""
    plan, kept = _two_joins(consumer)
    reads = [({"transfers": 0, "capacity": 4000, "rows": kept[0]},
              "op.HashJoin.run"),
             ({"transfers": 0, "capacity": kept[0], "rows": kept[1]},
              "op.HashJoin.run")]
    assert 0 < kept[1] < kept[0] < 4000
    assert _reads(plan, "join.num_rows") == (
        reads if consumer == "ScalarAggregate" else reads[:1])


def test_a_star_query_syncs_in_order(recorded):
    """The star's syncs, in order: its first join's count (the second binds
    masked under the dense group-by, which reads none), the flags, then the
    copy (the SUM is nullable: its validity is copied too)."""
    tracing.start()
    cols = run_query(star()[0])
    tracing.stop()
    spans = tracing.spans()
    syncs = [s for s in spans if s.name.startswith("sync.")]
    assert [s.name for s in syncs] == (
        ["sync.join.num_rows", "sync.flags", "sync.copy.num_rows"]
        + ["sync.copy.values"] * len(cols) + ["sync.copy.valid"])
    assert syncs[0].attrs == {"transfers": 0, "capacity": 4000,
                              "rows": int((FACT.to_numpy()["v"] > 100).sum())}
    assert (spans[syncs[0].parent].name, spans[syncs[0].parent].attrs) == (
        "op.HashJoin.run", {"name": "HashJoin", "route": "rowid"})
    assert all(s.attrs == {"transfers": 0} for s in syncs[1:])
    assert all(spans[s.parent].name in ("query.finish", "query.copy")
               for s in syncs[1:])


def test_a_group_by_over_a_compacting_join_reads_nothing(recorded):
    """A sort-path group-by over a Compute over a compacting join: the
    join's row count is a host int, so the group-by takes its prefix and
    opens no ``sync.agg.num_rows`` span."""
    plan, kept = _two_joins("ScalarAggregate")
    j2 = plan.child.child
    plan = T.GroupAggregate(["q"], [T.AggSpec(T.Aggregation.MIN, "v", "mn")],
                            T.Compute([T.col("q"), T.col("v")], j2))
    assert _reads(plan) == []
    assert len(_reads(plan, "join.num_rows")) == 2


def test_a_subclass_bind_calling_its_parents_opens_one_span(recorded):
    plan = T.BestEffortGroupAggregate(
        ["g"], [T.AggSpec(T.Aggregation.SUM, "pk", "s",
                          output_type=T.INT64)], T.ScanTable(DIM))
    tracing.start()
    run_query(plan)
    tracing.stop()
    names = [s.name for s in tracing.spans() if s.name.startswith("op.")]
    assert names.count("op.BestEffortGroupAggregate.bind") == 1
    assert "op.BestEffortGroupAggregate.run" in names


def test_the_span_list_is_bounded(recorded, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 7)
    tracing.start()
    run_query(q1()[0])
    tracing.stop()
    assert len(tracing.spans()) == 7 and tracing.dropped > 0
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped == 0


def test_launch_counters_are_the_registrys():
    assert kernels.launches is tracing.launches
    assert kernels.reset_launches is tracing.reset_launches
    assert set(kernels.launches) == {"compaction", "lut_gather",
                                     "segment_reduce", "segment_reduce_small",
                                     "spread", "merge_sorted"}
    kernels.launches["spread"] += 2
    kernels.reset_launches()
    assert set(kernels.launches.values()) == {0}


class _FakeEvent:
    """A CUDA timing event's interface, on a clock the test sets."""

    clock = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.at = None

    def record(self, stream):
        assert stream == "stream"
        self.at = _FakeEvent.clock

    def query(self):
        return self.at is not None and self.at <= _FakeEvent.done

    def elapsed_time(self, end):
        return end.at - self.at


def test_node_device_times_resolve_and_reuse_their_events(recorded,
                                                          monkeypatch):
    """On CUDA tables a node's run records a pair of events (a leaf's does
    not); a query's phase that ends after they completed resolves them
    into ``device_ms`` and reuses them, ``spans()`` resolves the rest."""
    from types import SimpleNamespace

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _FakeEvent.made, _FakeEvent.done = 0, 0.0
    ctx = SimpleNamespace(leaf_tables=[SimpleNamespace(
        device=torch.device("cuda", 0))])
    outer = SimpleNamespace(name="GroupAggregate", route="sort", timed=True)
    inner = SimpleNamespace(name="HashJoin", route="fat_lut", timed=True)
    leaf = SimpleNamespace(name="ScanTable", route=None, timed=False)

    def query(t0):
        with tracing.span("query.run", new_query=True):
            _FakeEvent.clock = t0
            with tracing.node(outer, ctx):
                _FakeEvent.clock = t0 + 1
                with tracing.node(inner, ctx):
                    with tracing.node(leaf, ctx):
                        pass
                    _FakeEvent.clock = t0 + 3
                _FakeEvent.clock = t0 + 7

    tracing.start()
    query(0.0)                     # its work has not completed
    assert _FakeEvent.made == 4
    _FakeEvent.done = 7.0          # now it has
    with tracing.span("query.finish"):
        pass
    query(10.0)
    assert _FakeEvent.made == 4    # its events are reused
    tracing.stop()
    got = [(s.name, s.device_ms) for s in tracing.spans()
           if s.name.startswith("op.")]
    # a leaf that launches nothing is not timed
    assert got == [("op.GroupAggregate.run", 7.0), ("op.HashJoin.run", 2.0),
                   ("op.ScanTable.run", None)] * 2
