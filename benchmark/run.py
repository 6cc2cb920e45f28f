"""The benchmark of supersonic_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json: a configuration
(``benchmark/configs/<name>.json``, whose generator makes the data from the
seed on the card) under a traffic mix (``benchmark/traffic/<name>.json``).
After set-up and a warm-up of the cell's queries, one client runs queries
in a closed loop for ``--seconds``.  With ``--trace 0`` the last line of
standard output is the result with the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` and the line holds
the per-layer metrics, the device's busy and window seconds and a
breakdown.  Every answer of the window is compared with the plain
reference (``benchmark/reference``) after the window; the numbers compared
are printed with their limits as the last lines of standard error and
under ``checks``, last on the result line.  A cell on P > 1 cards runs one
rank a card (``benchlib/cards.py``), with rank 0 as the coordinator.

Exits 2 without as many CUDA cards as the cell asks for or without the
program beside the benchmark, 3 if JAX or the JAX package was loaded, 4 if
a rank of a cell on many cards failed or hung; no result is printed then.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_age_s() -> float:
    """Seconds since this process started (clock ticks of /proc), so set-up
    counts the interpreter's own start too; 0 where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)


def caches_inside_checkout() -> None:
    """Build and kernel caches in fixed directories of the checkout."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _json_safe(x):
    """Non-finite floats (a check of an answer that never matched) as
    strings, so the line stays JSON."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    started = STARTED - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches_inside_checkout()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from benchlib import cell, compare, registry

    chips = next((w["chips"] for w in registry.manifest()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        import supersonic_tpu_torch
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 2
    if ROOT not in pathlib.Path(supersonic_tpu_torch.__file__).parents:
        print(f"supersonic_tpu_torch was loaded from outside the checkout "
              f"({supersonic_tpu_torch.__file__})", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    if chips == 1:
        line = cell.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", started)
    else:
        from benchlib import cards

        try:
            line = cards.run(args.workload, chips, args.seed, args.seconds,
                             bool(args.trace), "cuda", started)
        except cards.Failed as e:
            print(f"{args.workload}: {e}", file=sys.stderr)
            return e.code
    found = cell.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, x in line["checks"].items():
        print(f"check {name}: {x['value']!r} (limit {x['limit']!r})",
              file=sys.stderr)
    print(f"correct: {compare.passed(line['checks'])}", file=sys.stderr,
          flush=True)
    print(json.dumps(_json_safe(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
