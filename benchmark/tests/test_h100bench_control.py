"""The control fails (card only): for each cell, its driver's control (the
reference put in the program's place and computed in the precision below
the configuration's: TF32 for float32 with TF32 off) comes out not correct
against the reference at the cell's batch and column sizes (a smaller pool
of traffic), while the program's own run comes out correct. Run on the card
with

    python -m pytest -p no:cacheprovider benchmark/tests/test_h100bench_control.py -m gpu
"""

from __future__ import annotations

import json
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2**31 + 977
CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
SMALLER = {"train": lambda mix: {"rooms": mix["batch"] * mix["group_steps"], "draws": 1}}  # by driver


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control computes in TF32")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    from pn2bench import harness

    cell = harness.find_cell(json.loads((BENCH.parent / "BENCHMARK.json").read_text()), name)
    cell.mix.update(SMALLER[cell.mix["driver"]](cell.mix))
    res = harness.run_cell(cell, SEED, 1.0, False, [card])
    assert res["correct"] is True, res["checks"]
    control = harness.driver_of(cell).controls(res["_ctx"])["control"]
    assert any(control[k] > limit for k, limit in cell.limits.items()), control
