"""The program's own spans of a traced window, laid over its device timeline.

The program records its spans (``supersonic_tpu_torch.tracing``) while the
profiler records: each query's phases (``query.bind``, ``query.prepare``,
``query.run``, ``query.finish``, ``query.copy``), each operator's bind and
run (``op.<Class>.bind``, ``op.<Class>.run``, the run with the node's
device-stream ms), each host sync (``sync.<site>``, with its transfers) and
each kernel wrapper's marshalling and launch (``kernel.<name>``), on
``time.time_ns()``, the clock of the profiler's events.  The first reader of
a window takes the spans out of the program (so the next window starts
empty); where the program records none, as a commit before its tracing, the
view is None and every metric that reads it returns None.

Each idle stretch of the device timeline is charged to the innermost span
open on the host at that time: a span's own idle is the idle inside it less
the idle inside its children.  An operator node's own device ms is its
device-stream ms less that of the nodes it runs.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

from benchlib.trace import _coverage, _union

RECORDER = "supersonic_tpu_torch.tracing"
JOINS = ("HashJoin", "RowidMergeJoin", "ForeignFilter")
AGGREGATES = ("GroupAggregate", "ScalarAggregate", "BestEffortGroupAggregate",
              "HybridGroupAggregate", "AggregateClusters")
EXPRESSIONS = ("Filter", "Compute", "Project")


@dataclass
class View:
    """The spans of one window: ``spans[i]`` is (name, start_ns, end_ns,
    parent index, query id, attrs, device ms or None)."""

    spans: list
    idle_ns: list        # inclusive idle ns inside each span
    own_idle_ns: list    # idle ns charged to each span itself
    own_device_ms: list  # an operator run's own device ms, else None

    def top(self, name: str):
        """Indices of ``name`` spans opened outside any other span."""
        return [i for i, s in enumerate(self.spans)
                if s[0] == name and s[3] < 0]

    def node_ms(self, classes) -> float:
        """Own device ms of the operator runs of ``classes``."""
        return sum(ms for s, ms in zip(self.spans, self.own_device_ms)
                   if ms is not None and s[5].get("name") in classes)

    def has_node(self, classes) -> bool:
        return any(ms is not None and s[5].get("name") in classes
                   for s, ms in zip(self.spans, self.own_device_ms))


def _is_run(name: str) -> bool:
    return name.startswith("op.") and name.endswith(".run")


def is_glue(name: str) -> bool:
    """An operator's run or a kernel wrapper: host code inside the plan."""
    return _is_run(name) or name.startswith("kernel.")


def build(spans, device) -> View:
    """``spans``: (name, start, end, parent, query, attrs, device_ms)
    tuples; ``device``: ``Trace.device`` records (name, kind, start_ns,
    dur_ns, own)."""
    upto = _coverage(_union([(s, s + d) for _, _, s, d, _ in device]))
    idle = [(e - s) - (upto(e) - upto(s)) for _, s, e, *_ in spans]
    own_idle = list(idle)
    own_dev = [ms if _is_run(n) else None for n, *_, ms in spans]
    for i, (name, _s, _e, parent, *_rest) in enumerate(spans):
        if parent >= 0:
            own_idle[parent] -= idle[i]
        if own_dev[i] is None:
            continue
        # the nearest enclosing operator run ran this one
        p = parent
        while p >= 0 and own_dev[p] is None:
            p = spans[p][3]
        if p >= 0:
            own_dev[p] -= spans[i][6]
    return View(spans, idle, own_idle, own_dev)


def view(trace):
    """The program's spans of ``trace``'s window as a ``View``, or None
    where the program recorded none; taken once a window."""
    if "_program" in vars(trace):
        return trace._program
    rec = sys.modules.get(RECORDER)
    got = None
    if rec is not None and hasattr(rec, "spans"):
        spans = [(s.name, s.start_ns,
                  s.start_ns if s.end_ns is None else s.end_ns, s.parent,
                  s.query, s.attrs, s.device_ms) for s in rec.spans()]
        rec.clear()
        if spans:
            got = build(spans, trace.device)
    trace._program = got
    return got
