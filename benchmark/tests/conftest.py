"""The benchmark's CPU tests: one torch thread, the benchmark's modules on
the path, and its cells cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {  # by driver
    "train": {"rooms": 4, "room_points": 3000, "draws": 1, "batch": 2, "npoints": 1024, "group_steps": 2,
              "trace_groups": 1},
}


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="session")
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def small_cell(bench: dict, name: str):
    """The cell with its traffic cut to the CPU's size (the model keeps
    its published widths)."""
    from pn2bench import harness

    cell = harness.find_cell(bench, name)
    cell.mix.update(SMALL[cell.mix["driver"]])
    return cell
