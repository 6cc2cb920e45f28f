#!/usr/bin/env python3
"""Device time of the segment-reduce kernel at the headline group-by's
shape, for one or more checkouts of the port, on one CUDA card.

The script builds chip_smoke.py's headline data (100M fact rows, 1M dim
rows, 64 groups, from default_rng(42)) and the group-by's inputs: g (the
dim's group of each fact row, int32), keep (v > 0.5) and v (f32).  Then,
for each checkout named by ``--roots`` in turn (default: this one), it
times with that checkout's wrappers:

  * ``keyed``: ``segment_reduce_keyed`` over the raw g, keep and the row
    count, COUNT and SUM(v) (the headline aggregate's call), and its parts
    ``keyed_count`` (COUNT alone) and ``keyed_sum`` (SUM(v) alone), where
    the checkout has it;
  * ``ids``: ``segment_reduce_multi`` over ids = g where kept, else -1,
    with a 0/1 int32 count lane and v (the ids form, the call of checkouts
    before the keyed form);
  * ``small``: ``segment_reduce_small`` SUM(v) over g (every id in range).

Each time is the CUDA-event median of 10 windows of 5 back-to-back calls
(``chip_smoke.cuda_ms``), beside its byte bound (each input read once,
each output written once, over 3.35 TB/s) and a ``torch.profiler`` split
of 5 calls into device ms per kernel and memset row.  The launches of one
call and the registers of the kernels (from the checkout's ``ptxas.log``)
are printed beside them.  Each checkout's counts must equal the first
one's, and its sums agree within rtol 1e-4.  One JSON line per checkout.

``--roots P C C P`` compares the checkouts of two commits in one process,
in turns, on the same inputs.

    python3 scripts/measure_torch_segment_reduce.py [--roots DIR ...]
"""
import argparse
import json
import pathlib
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

HERE = pathlib.Path(__file__).resolve().parent.parent
PKG = "supersonic_tpu_torch"
REPS = 5


def profile_split(fn):
    """Device ms per call of every kernel (and memset) row of fn()."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            out[e.key[:80]] = e.self_device_time_total / REPS / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def load(root):
    """(segment_reduce module, kernels package) of the checkout ``root``."""
    for name in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    try:
        from supersonic_tpu_torch import kernels
        from supersonic_tpu_torch.kernels import segment_reduce
        return segment_reduce, kernels
    finally:
        sys.path.pop(0)


def registers(kernels):
    """'function: N registers' of the checkout's segment-reduce kernels."""
    log = kernels.BUILD_DIR / "ptxas.log"
    if not log.exists():
        return []
    out, fn = [], None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "Used" in line and fn and "segment_reduce_cu" in fn:
            out.append(f"{fn}: {line.split('Used')[1].strip()}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="*", default=[str(HERE)])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_segment_reduce: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    fact, dim = smoke.make_data()
    fk = torch.from_numpy(fact["fk"]).to(dev)
    v = torch.from_numpy(fact["v"]).to(dev)
    g = torch.from_numpy(dim["g"]).to(dev)[fk.long()]
    del fk
    keep = v > 0.5
    ids = torch.where(keep, g, -1).to(torch.int32)
    live = keep.to(torch.int32)
    n, K = v.shape[0], smoke.GROUPS
    nr = torch.tensor(n, dtype=torch.int64, device=dev)
    bounds = {"keyed": smoke.bound_ms(n * (4 + 1 + 4) + K * (8 + 4)),
              "ids": smoke.bound_ms(n * (4 + 4 + 4) + K * (8 + 4)),
              "keyed_count": smoke.bound_ms(n * (4 + 1) + K * 8),
              "keyed_sum": smoke.bound_ms(n * (4 + 1 + 4) + K * 4),
              "small": smoke.bound_ms(n * (4 + 4) + K * 4)}
    first = None
    for turn, root in enumerate(args.roots):
        sr, kernels = load(root)
        kernels.library()
        calls = {
            "ids": lambda: sr.segment_reduce_multi(
                [(live, "count"), (v, "sum")], ids, K),
            "small": lambda: [sr.segment_reduce_small(v, g, K, "sum")],
        }
        if hasattr(sr, "segment_reduce_keyed"):
            for name, reqs in (
                    ("keyed", [(None, None, "count"), (v, None, "sum")]),
                    ("keyed_count", [(None, None, "count")]),
                    ("keyed_sum", [(v, None, "sum")])):
                calls[name] = (lambda reqs=reqs: sr.segment_reduce_keyed(
                    [(g, 0, K)], reqs, K, keep=keep, num_rows=nr)[0])
        rec = {"turn": turn, "root": root, "card": smi,
               "registers": registers(kernels)}
        outs = {}
        for name, fn in calls.items():
            kernels.reset_launches()
            outs[name] = [t.clone() for t in fn()]
            torch.cuda.synchronize()
            launched = sum(kernels.launches.values())
            rec[name] = {"ms": smoke.cuda_ms(torch, fn),
                         "bound_ms": bounds[name], "launches": launched,
                         "profile": profile_split(fn)}
        if "keyed" in outs:  # the keyed and ids forms agree
            assert torch.equal(outs["keyed"][0], outs["ids"][0])
            torch.testing.assert_close(outs["keyed"][1], outs["ids"][1],
                                       rtol=1e-4, atol=0)
        if first is None:
            first = outs
        for name in outs:
            if name not in first:
                continue
            for a, b in zip(outs[name], first[name]):
                if a.dtype == torch.int64:
                    assert torch.equal(a, b), (root, name)
                else:
                    torch.testing.assert_close(a, b, rtol=1e-4, atol=0)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
