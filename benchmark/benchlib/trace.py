"""The traced window: ``torch.profiler`` over CPU and CUDA activity, the
benchmark's own spans around each call that ``execute`` makes, and the
reduction of the trace to what the per-layer metrics read.

Device activity is every kernel, memcpy and memset on the card.  Its union
over the window is the device's busy time; what is left is idle, and each
idle stretch is charged to the benchmark span open on the host at that time
(``plan``, ``bind``, ``prepare``, ``run``, ``finish``, ``copy``; ``harness``
between them).  A kernel is the program's own when its name is that of a
``__global__`` function in the program's ``csrc`` sources or of a
``@triton.jit`` function in its Python sources, read from the program's
files at run time, so a kernel that a later change adds is counted as its
own; every other device activity (ATen, cub, thrust, memset, memcpy) is a
library's.
"""
from __future__ import annotations

import bisect
import pathlib
import re
from dataclasses import dataclass, field

SPANS = ("plan", "bind", "prepare", "run", "finish", "copy")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)\s*\(")


def own_kernel_names(package: pathlib.Path) -> set:
    """Names of the kernels written in the program's own sources."""
    names = set()
    for path in package.rglob("*.cu*"):
        names |= set(_GLOBAL.findall(path.read_text(errors="replace")))
    for path in package.rglob("*.py"):
        text = path.read_text(errors="replace")
        if "triton" in text:
            names |= set(_TRITON.findall(text))
    return names


LIBRARY_NAMESPACES = ("at::", "c10::", "cub", "thrust::", "cutlass::")


def is_own_kernel(name: str, own_names: set) -> bool:
    """Whether a demangled kernel name (``void (anonymous
    namespace)::seg_kernel<4>(SegArgs, int)``) is one of ``own_names``
    outside a library's namespace."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)::", "")
    head = head.split("<", 1)[0].split("(", 1)[0].strip()
    qualifier, _, base = head.rpartition("::")
    return base in own_names and not (qualifier + "::").startswith(
        LIBRARY_NAMESPACES)


@dataclass
class Trace:
    """What the per-layer metrics read from one traced window."""

    queries: int
    window_s: float
    host_s: dict                  # span name -> host-clock seconds, summed
    device: list                  # (name, kind, start_ns, dur_ns, own)
    busy_s: float
    idle_s: dict = field(default_factory=dict)   # span name -> idle seconds

    def device_ms(self, kinds=("kernel", "memcpy", "memset"), own=None):
        """Device ms in activity of ``kinds``; ``own`` True/False keeps only
        the program's own kernels or only the others."""
        return sum(d for _, k, _, d, o in self.device
                   if k in kinds and (own is None or o == own)) / 1e6

    def count(self, kind, name_part=""):
        return sum(1 for n, k, _, _, _ in self.device
                   if k == kind and name_part in n)


def _kind(event):
    """kernel, memcpy or memset for a device event; None for the spans
    that the profiler mirrors on the device (``gpu_user_annotation``).
    Read from the name: torch 2.11's events carry no activity type."""
    name = event.name()
    if event.is_user_annotation() or name.startswith("bench."):
        return None
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _coverage(union):
    """t -> ns before t that ``union`` (sorted, disjoint) covers."""
    starts = [a for a, _ in union]
    before = [0]
    for a, b in union:
        before.append(before[-1] + b - a)

    def upto(t):
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0
        a, b = union[i]
        return before[i] + min(t, b) - a

    return upto


def reduce(events, own_names: set, queries: int, host_s: dict) -> Trace:
    """``events``: the profiler's kineto events of the traced window."""
    import torch

    spans, device = [], []
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith("bench.") and name[6:] in SPANS:
                spans.append((start, start + dur, name[6:]))
            continue
        kind = _kind(ev)
        if kind is None:
            continue
        own = kind == "kernel" and is_own_kernel(name, own_names)
        device.append((name, kind, start, dur, own))
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    w0 = min(s for s, _, _ in spans)
    w1 = max(e for _, e, _ in spans)
    union = _union([(max(s, w0), min(s + d, w1)) for _, _, s, d, _ in device
                    if s + d > w0 and s < w1])
    busy = sum(b - a for a, b in union)
    upto = _coverage(union)
    idle = {}
    in_spans = 0
    for s, e, name in spans:
        gap = (e - s) - (upto(e) - upto(s))
        idle[name] = idle.get(name, 0) + gap
        in_spans += gap
    idle["harness"] = (w1 - w0 - busy) - in_spans
    return Trace(queries, (w1 - w0) / 1e9, host_s, device, busy / 1e9,
                 {k: v / 1e9 for k, v in idle.items()})


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by the
    span open on the host, each as [name, seconds]."""
    by_name: dict = {}
    for name, _, _, dur, _ in trace.device:
        by_name[name] = by_name.get(name, 0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.idle_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], d / 1e9] for n, d in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
