"""On the card, at each cell's own size: the control (the reference one
precision below the configuration's, in the program's place) comes out
not correct, on three seeds. Skips without a card."""
import pytest

from fedbench import harness, readings, tiny

CELLS = sorted(tiny.SHRINK)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    cell = harness.Cell(tiny.ROOT, name)
    for seed in (201, 202, 203):
        nums = readings.control_numbers(cell, seed, card)
        ok, checks = harness.compare_mod.check(nums,
                                               cell.workload["limits"])
        assert not ok, checks
