"""Benchmark & observability subsystem.

Port of ``supersonic_tpu/bench/harness.py`` (reference:
supersonic/benchmark/ — SpyCursor wrapping (spy.cc:47), per-node
BenchmarkListener stats (benchmark_listener.h:28), BenchmarkType
classification (benchmark_types.h:29-70), cursor statistics
(cursor_statistics.h:34, metric definitions benchmark/proto/
benchmark.proto:9-54), and GraphViz DOT rendering (dot_drawer.h:53;
facade benchmark_manager.h:60-135 ``PerformBenchmark``).

Each plan node is timed as its own plan (its subtree run to the end), and
its self time is its subtree's time minus its children's subtree times.
A subtree is bound once by ``compile_plan`` and run once as a warm-up;
then each timed run ends in its one host sync (the error flags' read,
``ops/base.py::finish``), between a pair of CUDA events on the card, or
on the host clock on the CPU; the best of ``iters`` runs counts.  Metric
names follow benchmark.proto: ``rows_processed``, ``processing_time``
(µs), ``throughput`` (rows/µs), ``return_rate``; the DOT output mirrors
DOTDrawer's node/edge layout.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops.base import Operation, compile_plan, finish, prepare_leaves

# BenchmarkType classification (reference: benchmark_types.h:29-70)
_BENCHMARK_TYPES = {
    "ScanTable": "LEAF",
    "ScanTableWithSelection": "LEAF",
    "Generate": "LEAF",
    "Project": "TRANSPARENT",
    "Compute": "PASS_ALL",
    "Filter": "PASS_SOME",
    "Limit": "PASS_SOME",
    "Coalesce": "PASS_ALL",
    "Sort": "PREPROCESS",
    "ExtendedSort": "PREPROCESS",
    "GroupAggregate": "PREPROCESS",
    "BestEffortGroupAggregate": "MAY_PREPROCESS",
    "ScalarAggregate": "PREPROCESS",
    "AggregateClusters": "PASS_SOME",
    "HashJoin": "JOIN",
    "MergeUnionAll": "PASS_ALL",
    "RowidMergeJoin": "JOIN",
    "ForeignFilter": "PASS_SOME",
}


def plan_children(op: Operation) -> list[Operation]:
    """Child operations of a plan node (the ApplyToChildren analogue)."""
    out = []
    for attr in ("child", "lhs", "rhs"):
        c = getattr(op, attr, None)
        if isinstance(c, Operation):
            out.append(c)
    for c in getattr(op, "children", []) or []:
        if isinstance(c, Operation):
            out.append(c)
    return out


@dataclass
class NodeStats:
    """Per-node benchmark record (reference: benchmark.proto:9-54)."""

    name: str
    benchmark_type: str
    rows_processed: int = 0          # output rows of this node
    input_rows: int = 0              # sum of children's output rows
    subtree_time_us: float = 0.0     # time of the subtree's run
    processing_time_us: float = 0.0  # self time (subtree - children)
    # JOIN nodes only (reference: benchmark.proto:40-47): build vs probe
    index_set_up_time_us: Optional[float] = None
    matching_time_us: Optional[float] = None
    children: list["NodeStats"] = field(default_factory=list)

    @property
    def throughput(self) -> float:
        """rows/µs (reference: benchmark.proto throughput)."""
        if self.processing_time_us <= 0:
            return float("inf")
        return self.rows_processed / self.processing_time_us

    @property
    def return_rate(self) -> float:
        """output rows / input rows (%), reference: return_rate."""
        if self.input_rows == 0:
            return 100.0
        return 100.0 * self.rows_processed / self.input_rows


def _time_subtree(op: Operation, iters: int) -> tuple[float, int]:
    """Time one plan subtree; returns (best time in seconds, output rows).
    CUDA events on the card, the host clock on the CPU; each run ends in
    its host sync."""
    run, _bound, leaves = compile_plan(op)
    leaves = prepare_leaves(leaves, run.lazy)

    def once():
        out, flags, names = run(leaves)
        finish(run, flags, names)
        return out

    rows = int(once().num_rows)  # warm-up
    on_card = any(t.device.type == "cuda" for t in leaves)
    best = float("inf")
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            once()
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            once()
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return best, rows


def _empty_probe_like(op: Operation):
    """A 0-row ScanTable with the schema/dictionaries of ``op``'s output,
    on its leaves' device — used to time a join's build phase alone."""
    from ..batch import Table
    from ..ops.base import bind_plan
    from ..ops.scan import ScanTable
    from ..types import physical_dtype

    bound, leaves = bind_plan(op)
    vals = {a.name: np.zeros(0, physical_dtype(a.type))
            for a in bound.schema}
    valids = {a.name: None for a in bound.schema}
    device = leaves[0].device if leaves else "cpu"
    t = Table.from_arrays(bound.schema, vals, valids, 0,
                          dict(bound.dicts), capacity=1, device=device)
    return ScanTable(t)


def _join_phase_split(node, st: "NodeStats", kids: list["NodeStats"],
                      iters: int) -> None:
    """Split a HashJoin's self time into index_set_up_time vs
    matching_time (reference: cursor_statistics.h:153-167,
    benchmark.proto:40-47).

    The build phase is isolated by re-timing the join with the probe
    side replaced by an empty leaf: the run still builds the rhs index
    (LUT scatter / build-side sort) but probes nothing.
    index_set_up_time = that time minus the rhs subtree;
    matching_time = the node's remaining self time.
    """
    from ..ops.hash_join import HashJoin

    try:
        build_only = HashJoin(
            node.join_type, node.lhs_keys, node.rhs_keys,
            _empty_probe_like(node.lhs), node.rhs, node.uniqueness,
            lhs_projector=node.lhs_projector,
            rhs_projector=node.rhs_projector,
            allow_dense_lookup=node.allow_dense_lookup)
        secs, _ = _time_subtree(build_only, iters)
    except Exception as e:
        # best-effort instrumentation, but never SILENTLY best-effort:
        # a broken build-only re-timing must be visible, not read as
        # "no split reported"
        import logging

        logging.getLogger(__name__).warning(
            "join phase split skipped: build-only re-timing failed: %r", e)
        return
    rhs_kid = kids[-1] if kids else None
    rhs_time = rhs_kid.subtree_time_us if rhs_kid else 0.0
    st.index_set_up_time_us = max(secs * 1e6 - rhs_time, 0.0)
    st.matching_time_us = max(
        st.processing_time_us - st.index_set_up_time_us, 0.0)


def benchmark_plan(op: Operation, iters: int = 3) -> NodeStats:
    """``PerformBenchmark`` equivalent: per-node stats over the plan tree."""
    from ..ops.hash_join import HashJoin

    def visit(node: Operation) -> NodeStats:
        kids = [visit(c) for c in plan_children(node)]
        secs, rows = _time_subtree(node, iters)
        st = NodeStats(
            name=type(node).__name__,
            benchmark_type=_BENCHMARK_TYPES.get(type(node).__name__,
                                                "PASS_ALL"),
            rows_processed=rows,
            input_rows=sum(k.rows_processed for k in kids),
            subtree_time_us=secs * 1e6,
            children=kids,
        )
        st.processing_time_us = max(
            st.subtree_time_us - sum(k.subtree_time_us for k in kids), 0.0)
        if isinstance(node, HashJoin):
            _join_phase_split(node, st, kids, iters)
        return st

    return visit(op)


def format_stats(root: NodeStats) -> str:
    """Human-readable per-node table (ViewPrinter-style)."""
    lines = [f"{'node':<28} {'type':<14} {'rows':>10} {'self µs':>12} "
             f"{'rows/µs':>10} {'return %':>9}"]

    def walk(n: NodeStats, depth: int):
        name = "  " * depth + n.name
        tp = (f"{n.throughput:.2f}" if n.throughput != float("inf")
              else "inf")
        lines.append(f"{name:<28} {n.benchmark_type:<14} "
                     f"{n.rows_processed:>10} {n.processing_time_us:>12.1f} "
                     f"{tp:>10} {n.return_rate:>8.1f}%")
        if n.index_set_up_time_us is not None:
            lines.append(
                "  " * depth
                + f"  [join: index_set_up {n.index_set_up_time_us:.1f} µs, "
                  f"matching {n.matching_time_us:.1f} µs]")
        for k in n.children:
            walk(k, depth + 1)

    walk(root, 0)
    # Eager PyTorch has no compiler fusing nodes, so the self times sum to
    # about the whole plan's time, but not exactly: bind fuses a Filter
    # into the operator above it (a keep mask) and a UNIQUE join into the
    # aggregate or sort above it, so a child timed as its own plan can cost
    # more than inside its parent (its parent's self time is then clamped
    # to zero), and the separate runs add their timing noise
    lines.append(
        f"{'whole plan':<43} {'':>10} {root.subtree_time_us:>12.1f}"
        f"  (sum of per-node self: {_sum_self(root):.1f} µs)")
    return "\n".join(lines)


def _sum_self(n: NodeStats) -> float:
    return n.processing_time_us + sum(_sum_self(k) for k in n.children)


def to_dot(root: NodeStats, title: str = "plan") -> str:
    """GraphViz DOT rendering (reference: dot_drawer.h:53 DOTDrawer)."""
    lines = [f'digraph "{title}" {{', "  node [shape=box, fontsize=10];"]
    counter = [0]

    def walk(n: NodeStats) -> str:
        nid = f"n{counter[0]}"
        counter[0] += 1
        label = (f"{n.name}\\n{n.benchmark_type}\\n"
                 f"rows: {n.rows_processed}\\n"
                 f"self: {n.processing_time_us:.0f} us\\n"
                 f"throughput: "
                 f"{0 if n.throughput == float('inf') else n.throughput:.2f}"
                 f" rows/us")
        lines.append(f'  {nid} [label="{label}"];')
        for k in n.children:
            kid = walk(k)
            lines.append(f"  {kid} -> {nid};")
        return nid

    walk(root)
    lines.append("}")
    return "\n".join(lines)


def save_dot(root: NodeStats, path: str, title: str = "plan") -> None:
    with open(path, "w") as f:
        f.write(to_dot(root, title))


def describe_plan(op: Operation, schemas: bool = True) -> str:
    """Human-readable plan tree (reference: AppendDebugDescription on every
    cursor/operation, cursor.h:189 / operation.h:65, and
    TupleSchema::GetHumanReadableSpecification).  The JAX package's text
    for the same plan."""
    from ..ops.base import bind_plan

    lines: list[str] = []

    def describe(node: Operation) -> str:
        name = type(node).__name__
        details = []
        for attr in ("join_type", "uniqueness", "order", "group_by",
                     "expressions", "limit", "offset"):
            v = getattr(node, attr, None)
            if v is None:
                continue
            if attr == "order":
                v = ", ".join(
                    f"{k.name} {'ASC' if k.ascending else 'DESC'}"
                    for k in v.keys)
            elif attr == "expressions":
                v = f"{len(v)} expr(s)"
            elif hasattr(v, "value"):
                v = v.value
            details.append(f"{attr}={v}")
        if schemas:
            try:
                bound, _ = bind_plan(node)
                spec = ", ".join(
                    f"{a.name}: {a.type.value}{'?' if a.nullable else ''}"
                    for a in bound.schema)
                details.append(f"schema=({spec})")
            except Exception:
                pass
        return f"{name}" + (f" [{'; '.join(details)}]" if details else "")

    def walk(node: Operation, depth: int) -> None:
        lines.append("  " * depth + describe(node))
        for c in plan_children(node):
            walk(c, depth + 1)

    walk(op, 0)
    return "\n".join(lines)
