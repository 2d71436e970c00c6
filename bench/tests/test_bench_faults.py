"""A run with the timed path broken underneath comes out not correct:
each fault the cell can have, planted under the port's step, at smoke
size on the CPU (the harness's look for a chip skipped)."""

import pytest

from bench.tests import smoke

SEED = 2 ** 31 + 7


@pytest.mark.parametrize("cell", [smoke.TRAIN_CELL, smoke.DECODE_CELL])
def test_sound_run_is_correct(cell):
    run = smoke.run(cell, SEED)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("cell,fault", [
    (smoke.TRAIN_CELL, "state_unchanged"),
    (smoke.TRAIN_CELL, "half_batch"),
    (smoke.DECODE_CELL, "state_unchanged"),
    (smoke.DECODE_CELL, "half_batch"),
    (smoke.DECODE_CELL, "token_altered"),
])
def test_fault_is_caught(cell, fault):
    run = smoke.run(cell, SEED, fault=fault)
    assert not run.correct, run.checks
