"""The control (the reference with fp8 products in the program's place)
comes out not correct: at smoke size on the CPU against the smoke
limits, and, on the card, at each cell's own size against its limits."""

import collections
import json
import subprocess
import sys

import pytest
import torch

from bench.harness import core
from bench.tests import smoke


@pytest.mark.parametrize("cell", [smoke.TRAIN_CELL, smoke.DECODE_CELL])
@pytest.mark.parametrize("seed", [11, 12, 2 ** 31 + 13])
def test_control_fails_at_smoke_size(cell, seed):
    run = smoke.run(cell, seed, control=True)
    limits = smoke.LIMITS[cell]
    assert any(run.control_readings[k] > limits[k] for k in limits), \
        run.control_readings


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [smoke.TRAIN_CELL, smoke.DECODE_CELL])
def test_control_fails_at_cell_size(card, cell):
    """Three seeds of the control at the cell's size, through
    ``bench/calibrate.py`` (about a minute a seed on one H100)."""
    out = subprocess.run(
        [sys.executable, str(core.BENCH / "calibrate.py"), "--workload", cell,
         "--seeds", "3000000101,3000000102,3000000103", "--seconds", "8",
         "--control", "1"], capture_output=True, text=True, check=True)
    limits = core.load_cell(cell)["limits"]
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith('{"seed"')]
    assert len(rows) == 3
    failed = collections.Counter(
        any(r["control"][k] > v for k, v in limits.items()) for r in rows)
    assert failed[True] == 3, rows
