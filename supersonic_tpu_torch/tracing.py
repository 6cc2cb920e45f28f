"""Spans and counters of the port.

A span is one piece of work where it happens: a phase of a query
(``query.bind``, ``query.prepare``, ``query.run``, ``query.finish``,
``query.copy``), an operator's bind or run (``op.<Class>.bind``,
``op.<Class>.run``), a host sync (``sync.<site>``) or a kernel wrapper's
marshalling and launch (``kernel.<name>``).  Each holds its name, its start
and end on ``time.time_ns()`` (the Unix-epoch clock that ``torch.profiler``
stamps its events with, so program spans and device activity share one
timeline), the index of its parent span, the id of its query and a small
dict of attributes.  A query id is handed out by the outermost
``query.bind`` of a thread (``compile_plan``); the thread's later spans
carry it until the next.

Spans are recorded only while a ``torch.profiler`` profile records, or
between ``start()`` and ``stop()``.  Anywhere else a span site costs one
check.  They are kept in memory, at most ``MAX_SPANS`` of them (later ones
are dropped and counted in ``dropped``), until ``clear()``.  A closed span
is a tuple of plain values, which the garbage collector stops tracking, so
a long window adds nothing to its passes.  An operator's run on CUDA
tables also records a pair of timing events on the current stream: event
records, not kernels, memcpys or memsets.  When a thread's outermost span
closes (a query's phase) and the last pair has completed, the pairs are
resolved into the nodes' device-stream ms (``device_ms``) and their events
reused; ``spans()`` resolves the rest.

The counters (``launches``: one a launch of each of the port's own kernels)
are always on.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

__all__ = ["Span", "MAX_SPANS", "launches", "reset_launches", "active",
           "start", "stop", "clear", "spans", "current", "span", "node",
           "sync", "to_host", "count_to_host", "traced_bind"]

# a 20 s window of the benchmark's shortest queries makes about 50 spans a
# query over ~1,230 queries
MAX_SPANS = 1 << 18

# kernel name -> launches since the last reset_launches() (read by the
# kernel tests, chip_smoke.py and the measurement scripts)
launches: dict[str, int] = {"compaction": 0, "lut_gather": 0,
                            "segment_reduce": 0, "segment_reduce_small": 0,
                            "spread": 0, "merge_sorted": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class Span(NamedTuple):
    """One recorded span; ``end_ns`` is None while it is open, and
    ``device_ms`` None where no device time was recorded."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int             # index in spans(), -1 at the top
    query: int
    attrs: dict
    device_ms: Optional[float]


# an open span is a list [name, start, None, parent, query, attrs, events,
# owner]; closing it stores the tuple of its first six, its attrs as a
# tuple of (key, value) pairs, and its device ms (None until resolved)
_END, _ATTRS, _EVENTS, _OWNER = 2, 5, 6, 7


class _Thread(threading.local):
    def __init__(self):
        self.stack: list = []       # indices of the open spans
        self.query = 0


_spans: list = []
_pending: list = []     # (index, begin, end) of closed timed runs
_free: list = []        # timing events to reuse
_lock = threading.Lock()
_local = _Thread()
_query_ids = itertools.count(1)
_forced = False
dropped = 0
_profiler_enabled = torch._C._autograd._profiler_enabled


def active() -> bool:
    """Whether spans are recorded now."""
    return _forced or _profiler_enabled()


def start() -> None:
    """Record spans until ``stop()``, with or without a profiler."""
    global _forced
    _forced = True


def stop() -> None:
    global _forced
    _forced = False


def clear() -> None:
    """Forget every recorded span (call it with no span open)."""
    global dropped
    _spans.clear()
    _pending.clear()
    dropped = 0


def _resolve(wait: bool) -> None:
    """The device ms of every closed timed run, once the last one's end
    event has completed (every earlier event on its stream has then too),
    or after a synchronize where ``wait``; their events go back to
    ``_free``."""
    with _lock:
        if not _pending:
            return
        if wait:
            torch.cuda.synchronize()
        elif not _pending[-1][2].query():
            return
        for i, begin, end in _pending:
            _spans[i] = _spans[i][:_EVENTS] + (begin.elapsed_time(end),)
            _free.extend((begin, end))
        _pending.clear()


def spans() -> list:
    """The recorded spans as ``Span``s, in the order they opened, each
    node's device time resolved."""
    _resolve(wait=True)
    return [Span(*r[:_EVENTS], None) if isinstance(r, list) else
            Span(*r[:_ATTRS], dict(r[_ATTRS]), r[_EVENTS]) for r in _spans]


def current() -> Optional[Span]:
    """The innermost span open on this thread, or None."""
    stack = _local.stack
    return Span(*_spans[stack[-1]][:_EVENTS], None) if stack else None


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """Opens a span on entry, giving its attribute dict (None where the
    span list is full), and closes it on exit."""

    __slots__ = ("name", "attrs", "owner", "cuda", "new_query", "index")

    def __init__(self, name, attrs, owner=None, cuda=False,
                 new_query=False):
        self.name = name
        self.attrs = attrs
        self.owner = owner
        self.cuda = cuda
        self.new_query = new_query
        self.index = -1

    def __enter__(self):
        global dropped
        local = _local
        stack = local.stack
        if self.new_query and not stack:
            local.query = next(_query_ids)
        if len(_spans) >= MAX_SPANS:
            dropped += 1
            return None
        events = None
        if self.cuda:
            stream = torch.cuda.current_stream()
            events = (stream, _take(), _take())
            events[1].record(stream)
        rec = [self.name, time.time_ns(), None, stack[-1] if stack else -1,
               local.query, self.attrs, events, self.owner]
        with _lock:
            self.index = len(_spans)
            _spans.append(rec)
        stack.append(self.index)
        return self.attrs

    def __exit__(self, *exc):
        i = self.index
        if i < 0:
            return False
        rec = _spans[i]
        if rec[_EVENTS] is not None:
            stream, begin, end = rec[_EVENTS]
            end.record(stream)
            with _lock:
                _pending.append((i, begin, end))
        rec[_END] = time.time_ns()
        # closed, it keeps no plan object alive, and a tuple of plain values
        # drops out of the garbage collector's passes
        _spans[i] = (*rec[:_ATTRS], tuple(rec[_ATTRS].items()), None)
        stack = _local.stack
        stack.pop()
        if not stack and _pending:
            # outside every span of the thread: after a query's phase
            _resolve(wait=False)
        return False


def _take():
    """A timing event: a resolved one again, or a new one."""
    try:
        return _free.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def span(name: str, new_query: bool = False, **attrs):
    """A context that records span ``name`` while spans are recorded;
    ``new_query`` hands out a new query id when no span of the thread is
    open."""
    if not (_forced or _profiler_enabled()):
        return _NULL
    return _Open(name, attrs, new_query=new_query)


def node(bound, ctx):
    """The span of a bound operator's run, ``op.<name>.run``, with its
    device-stream time where the plan's tables are on CUDA and the node
    launches work (``bound.timed``)."""
    if not (_forced or _profiler_enabled()):
        return _NULL
    leaves = ctx.leaf_tables
    cuda = (bound.timed and bool(leaves)
            and leaves[0].device.type == "cuda")
    return _Open(f"op.{bound.name}.run",
                 {"name": bound.name, "route": bound.route}, bound, cuda)


def sync(site: str, t, **attrs):
    """The span of a host sync at ``site`` that reads tensor ``t``: one
    device-to-host transfer where ``t`` is on CUDA, none elsewhere (a copy
    from the host, a CPU tensor), beside ``attrs``.  Entered, it gives the
    span's attribute dict (None where no span is recorded), which the
    caller may add to until the span closes."""
    if not (_forced or _profiler_enabled()):
        return _NULL
    cuda = isinstance(t, torch.Tensor) and t.is_cuda
    return _Open(f"sync.{site}", {"transfers": int(cuda), **attrs})


def to_host(t, site: str):
    """``t.cpu()`` inside the span of sync ``site``; anything but a tensor
    comes back as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    with sync(site, t):
        return t.cpu()


def count_to_host(count: torch.Tensor, site: str, capacity: int) -> int:
    """A 0-d row count of a lane of ``capacity`` rows as a host int, read
    inside the span of sync ``site``, which also records the count read
    (``rows``) and ``capacity``."""
    with sync(site, count, capacity=capacity) as attrs:
        rows = int(count.cpu())
        if attrs is not None:
            attrs["rows"] = rows
    return rows


def traced_bind(bind):
    """Wraps an operator class's ``bind``: the span ``op.<Class>.bind``, and
    the class's name stamped on the bound operator it returns (unless a
    deeper bind named it: a plan rewritten into other operators)."""
    @functools.wraps(bind)
    def wrapper(self, ctx, *args, **kwargs):
        if not (_forced or _profiler_enabled()):
            bound = bind(self, ctx, *args, **kwargs)
        else:
            stack = _local.stack
            if stack and _spans[stack[-1]][_OWNER] is self:
                # a subclass's bind calling the one it overrides
                bound = bind(self, ctx, *args, **kwargs)
            else:
                with _Open(f"op.{type(self).__name__}.bind", {}, self):
                    bound = bind(self, ctx, *args, **kwargs)
        if bound.name is None:
            bound.name = type(self).__name__
        return bound

    return wrapper
