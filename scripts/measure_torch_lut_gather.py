#!/usr/bin/env python3
"""What sets the floor of the port's lut_gather on one CUDA card.

Times, by CUDA-event medians over 10 windows of 5 back-to-back calls
after a warm-up (chip_smoke.py's ``cuda_ms``), the gather of
100M int32 indices from a 1M-entry int32 LUT (chip_smoke.py's row-id probe
shape, bench.py's data from default_rng(42)) with three index patterns:
random (the probe's fk), all equal (every LUT read hits one sector) and
``arange(n) % K`` (each 32-byte LUT sector serves 8 consecutive indices);
beside ``torch.index_select`` on each pattern and a copy of the index
(``clone``: the 400 MB read and 400 MB written that every pattern streams).
The gap between the random and the arange pattern is the cost of the random
LUT reads (100M reads, one 32-byte L2 sector each); the gap between arange
and the copy is the LUT traffic that no pattern avoids.

``--root DIR`` imports ``supersonic_tpu_torch`` from DIR instead of this
checkout, so the same script measures a checkout of another commit.  Prints
the card (nvidia-smi name and power limit), then one line per pattern.

    python3 scripts/measure_torch_lut_gather.py [--root DIR]
"""
import argparse
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent.parent
N = 100_000_000
K = 1_000_000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_torch_lut_gather: no CUDA device")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    # this checkout's timer, whatever tree the package comes from
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from supersonic_tpu_torch.kernels import library
    from supersonic_tpu_torch.kernels.lut_gather import lut_gather

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(f"card: {smi}; package from {args.root}")
    library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(42)
    fk = torch.from_numpy(rng.integers(0, K, N).astype(np.int32)).to(dev)
    lut = torch.from_numpy(rng.integers(0, 64, K).astype(np.int32)).to(dev)
    patterns = {
        "random": fk,
        "all equal": torch.full((N,), K // 2, dtype=torch.int32, device=dev),
        "arange % K": (torch.arange(N, device=dev) % K).to(torch.int32),
    }
    bound = (N * 4 + K * 4 + N * 4) / 3.35e12 * 1e3
    copy = smoke.cuda_ms(torch, lambda: fk.clone())
    print(f"clone of the index (400 MB read, 400 MB written): {copy:.6f} ms;"
          f" byte bound of the gather {bound:.6f} ms")
    for name, idx in patterns.items():
        assert torch.equal(lut_gather([lut], idx, K)[0],
                           torch.index_select(lut, 0, idx))
        k = smoke.cuda_ms(torch, lambda: lut_gather([lut], idx, K))
        lib = smoke.cuda_ms(torch, lambda: torch.index_select(lut, 0, idx))
        print(f"{name}: lut_gather {k:.6f} ms, index_select {lib:.6f} ms")


if __name__ == "__main__":
    main()
