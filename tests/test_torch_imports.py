"""The port stands alone: importing it loads neither JAX nor the JAX
package, and builds no kernel."""
import ast
import pathlib
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "supersonic_tpu_torch"


def test_import_leaves_jax_out():
    code = (
        "import sys; import supersonic_tpu_torch, supersonic_tpu_torch.ops, "
        "supersonic_tpu_torch.kernels.compaction, "
        "supersonic_tpu_torch.kernels.lut_gather, "
        "supersonic_tpu_torch.kernels.segment_reduce, "
        "supersonic_tpu_torch.kernels.spread, "
        "supersonic_tpu_torch.kernels.merge_sorted, "
        "supersonic_tpu_torch.ops.merge, supersonic_tpu_torch.ops.union, "
        "supersonic_tpu_torch.ops.compute, supersonic_tpu_torch.ops.aggregate, "
        "supersonic_tpu_torch.exprs.arithmetic, "
        "supersonic_tpu_torch.exprs.logic, "
        "supersonic_tpu_torch.exprs.elementary, "
        "supersonic_tpu_torch.exprs.terminal, "
        "supersonic_tpu_torch.exprs.math, supersonic_tpu_torch.exprs.string, "
        "supersonic_tpu_torch.exprs.regexp, supersonic_tpu_torch.exprs.date, "
        "supersonic_tpu_torch.exprs.tz, supersonic_tpu_torch.exprs.stateful, "
        "supersonic_tpu_torch.exprs.hashing, "
        "supersonic_tpu_torch.parallel.hashing, "
        "supersonic_tpu_torch.parallel, supersonic_tpu_torch.parallel.dist, "
        "supersonic_tpu_torch.parallel.multihost, "
        "supersonic_tpu_torch.bench, supersonic_tpu_torch.bench.harness, "
        "supersonic_tpu_torch.bench.headline, supersonic_tpu_torch.entry, "
        "supersonic_tpu_torch.testing, "
        "supersonic_tpu_torch.testing.operation_testing, "
        "supersonic_tpu_torch.reference.ref_engine, "
        "supersonic_tpu_torch.ops.segscan; "
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'supersonic_tpu' "
        "or m.startswith('supersonic_tpu.')); "
        "built = supersonic_tpu_torch.kernels._lib is not None; "
        "print(bad, built); sys.exit(1 if bad or built else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax():
    """No import statement anywhere in the package, function bodies
    included, names JAX or the JAX package."""
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "supersonic_tpu"), \
                    f"{path}:{node.lineno} imports {m}"


def test_kernel_sources_are_packaged():
    names = {p.name for p in (PKG / "csrc").iterdir()}
    assert {"common.cuh", "compaction.cu", "lut_gather.cu",
            "segment_reduce.cu", "spread.cu", "merge_sorted.cu"} <= names
    pyproject = (REPO / "pyproject.toml").read_text()
    assert '"supersonic_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in pyproject


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs on the card's machine, which has no JAX."""
    for node in ast.walk(ast.parse((REPO / "chip_smoke.py").read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "supersonic_tpu"), \
                f"chip_smoke.py:{node.lineno} imports {m}"
