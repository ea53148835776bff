"""Each cell's round through the harness at CPU-test sizes: the program
and the reference agree, every reader of the cell reports, and the
faults a cell can have make ``correct`` false."""
import time

import pytest
import torch

from fedbench import harness, readings, tiny

CELLS = sorted(tiny.SHRINK)


def _run(name, plant=None, seconds=0.3):
    from repro_torch.core.engine.driver import resolve_device
    cell = tiny.cell(name)
    out = harness.run(cell, 2 ** 40 + 3, seconds, True,
                      resolve_device("cpu"), time.perf_counter(),
                      log=lambda *_: None, plant=plant)
    return cell, out


@pytest.mark.parametrize("name", CELLS)
def test_cell_agrees_with_its_reference(name):
    cell, out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    # float32 on both sides: the first round's stages agree to rounding
    # (the rounds end to end part further where training is chaotic)
    stages = ("train_loss", "attack", "accuracy", "weights", "aggregate")
    assert max(out["numbers"][k] for k in stages) < 1e-4, out["numbers"]
    ends = harness.read_metrics(cell, out["record"], False)
    assert set(ends) == {m["name"] for m in cell.metrics(False)}


@pytest.mark.parametrize("fault", sorted(readings.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_correct_false(name, fault):
    _, out = _run(name, plant=readings.FAULTS[fault], seconds=0.0)
    assert not out["correct"], out["numbers"]


def test_seed_gives_the_same_inputs():
    from fedbench import traffic
    cell = tiny.cell(CELLS[0])
    one = traffic.make_data(cell.traffic, cell.config, 2 ** 33 + 1,
                            torch.device("cpu"))
    two = traffic.make_data(cell.traffic, cell.config, 2 ** 33 + 1,
                            torch.device("cpu"))
    assert all(torch.equal(one[k], two[k]) for k in one)
