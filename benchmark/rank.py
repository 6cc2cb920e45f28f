"""One rank of a cell on more than one card, as the launcher
(``benchlib/cards.py``, which ``run.py`` calls for such a cell) starts it:

    python3 benchmark/rank.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> --device <cuda|cpu> --rank <r> --ranks <P>
        --address <host:port> --started <t> --parent <pid>
        [--config <json>] [--control]

Its standard output is the pipe to the launcher, which carries only the
rank's messages (``benchlib.rankrun.Link``); whatever else the process
writes to standard output goes to standard error.  It dies with the
launcher.  Exits 1 with the traceback on standard error where the run
raises.
"""
import argparse
import ctypes
import json
import os
import pathlib
import signal
import sys
import traceback

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
PR_SET_PDEATHSIG = 1


def die_with(parent: int) -> bool:
    """Have the kernel kill this process when its parent ends; False where
    the parent has ended already."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG,
                                                signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    return os.getppid() == parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--address", required=True)
    ap.add_argument("--started", type=float, required=True)
    ap.add_argument("--parent", type=int, required=True)
    ap.add_argument("--config")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    link_out = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    if not die_with(args.parent):
        return 1
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    torch.set_num_threads(1)
    from benchlib import rankrun

    try:
        rankrun.run(args.workload, args.seed, args.seconds, bool(args.trace),
                    args.device, args.started, args.rank, args.ranks,
                    args.address, rankrun.Link(link_out),
                    json.loads(args.config) if args.config else None,
                    args.control)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
