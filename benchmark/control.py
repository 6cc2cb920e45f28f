"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up, then a window of the
cell's own traffic through the program, every answer compared with the
reference (the program's reading); then the control in the program's place:
the reference computed in the precision just below the one that the
configuration states (``low``: int32 sums that wrap for exact INT64 sums,
float32 for DOUBLE), over the same queries, compared in the same way (the
control's reading).  One JSON line a seed, then one with the largest
program reading and the smallest control reading of each number.  In a cell
on P > 1 cards the program's reading comes from a run of its ranks
(``benchlib/cards.py``), and the control's from the low-precision
reference on rank 0, over the same queries and the whole data set.
"""
import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent


def control_results(results, data, device):
    """The window's queries answered by the low-precision reference."""
    from benchlib import cell, registry

    ref = cell.reference_data(data, device)
    answers = {}
    out = []
    for r in results:
        if r.inst.key not in answers:
            a = registry.load_module("reference", r.inst.query).answer(
                ref, r.inst.params, low=True)
            answers[r.inst.key] = (list(a.columns), a.columns)
        names, cols = answers[r.inst.key]
        out.append(cell.Result(r.inst, names, cols, 0.0))
    return out


def chips(workload) -> int:
    from benchlib import registry

    return next(w["chips"] for w in registry.manifest()["workloads"]
                if w["name"] == workload)


def readings(workload, seed, seconds, device, config=None) -> dict:
    """The program's and the control's numbers compared for one seed."""
    import torch

    from benchlib import cell, compare, registry, traffic

    if chips(workload) > 1:
        return _ranked_readings(workload, seed, seconds, device, config)
    c = registry.cell(workload)
    if config is not None:
        c.config = config
    data, prog = cell.setup(c, seed, device, {})
    results, _ = cell.window(prog.answer, traffic.stream(c.traffic, seed),
                             seconds)
    del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    limits = c.traffic.get("limits", {})
    program, _ = cell.judge(results, data, limits, device)
    control, _ = cell.judge(control_results(results, data, device), data,
                            limits, device)
    return {"seed": seed, "answers": len(results),
            "program": {k: v["value"] for k, v in program.items()},
            "program_correct": compare.passed(program),
            "control": {k: v["value"] for k, v in control.items()},
            "control_correct": compare.passed(control)}


def _ranked_readings(workload, seed, seconds, device, config) -> dict:
    from benchlib import cards, compare

    first = cards.run_ranks(workload, chips(workload), seed, seconds, False,
                            device, time.perf_counter(), config,
                            control=True)[0]
    return {"seed": seed, "answers": first["attempted"],
            "program": {k: v["value"] for k, v in first["checks"].items()},
            "program_correct": compare.passed(first["checks"]),
            "control": {k: v["value"] for k, v in first["control"].items()},
            "control_correct": compare.passed(first["control"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips(args.workload)):
        print(f"control: {args.workload} needs {chips(args.workload)} CUDA "
              f"device(s)", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    lines = []
    for seed in args.seeds:
        t = time.perf_counter()
        lines.append(readings(args.workload, seed, args.seconds, "cuda"))
        lines[-1]["seconds"] = time.perf_counter() - t
        print(json.dumps(lines[-1]), flush=True)
    names = lines[0]["program"]
    print(json.dumps({
        "workload": args.workload, "seeds": len(lines),
        "program_max": {k: max(x["program"][k] for x in lines)
                        for k in names},
        "control_min": {k: min(x["control"][k] for x in lines)
                        for k in names},
        "control_all_incorrect": all(not x["control_correct"]
                                     for x in lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
