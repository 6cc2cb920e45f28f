"""Shared set-up of the benchmark's CPU tests: the benchmark's own folder
and the repository's root on ``sys.path``, one torch thread, small
configurations, and the ``card`` marker for tests that need a CUDA card
(they decide inside the test whether one is present)."""
import copy
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(1)

# small sizes of each schema's tables, for the CPU
SMALL_ROWS = {
    "ssb": {"lineorder": 200000, "part": 4000, "customer": 1500,
            "supplier": 100, "date": 2557},
    "tpch": {"lineitem": 60000, "part": 2000},
}
CELLS = ["ssb_sf20.star", "tpch_sf30.q1", "ssb_sf20.flight1",
         "tpch_sf30.q6"]


def small_config(workload: str) -> dict:
    from benchlib import registry

    cfg = copy.deepcopy(registry.cell(workload).config)
    cfg["rows"] = dict(SMALL_ROWS[cfg["schema"]])
    return cfg


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
