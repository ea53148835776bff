"""The reference CI's ``population-smoke`` job in both packages on the CPU,
round by round (``tools/population_ci_replay.py``): one set of shards,
one converted init, the reference's draws replayed.

Its first four rounds agree: the ``[K, N]`` counts exactly, weights,
scores and params within rtol 1e-4, atol 1e-5, whether the port carries
its own state (``free``) or starts each round from the reference's
(``synced``), and the malicious weight (the CI gate's metric) to 1e-6.
At seed 0 the series part in round 5, where one honest client's first
SGD step meets a ReLU pre-activation within rounding of zero (-1.2e-7 in
the reference's f32 convolution, +1.8e-7 in the port's), so its
gradients, and the trajectories after it, differ: f32 noise at a kink,
not a fault of the port (ROADMAP.md queue 3).

Torch runs on one thread, as the tool does.
"""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

ROUNDS = 4


@pytest.fixture(scope="module")
def replay():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "population_ci_replay.py")
    spec = importlib.util.spec_from_file_location("population_ci_replay",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    lines = []
    try:
        summary = tool.replay(seed=0, rounds=ROUNDS, emit=lines.append)
    finally:
        torch.set_num_threads(threads)
    return tool, summary, lines


def test_ci_job_rounds_agree_before_the_kink(replay):
    _, summary, lines = replay
    assert summary["rounds"] == ROUNDS and len(lines) == ROUNDS + 1
    assert summary["first_parted"] == {"free": None, "synced": None}
    assert summary["max_abs_malicious_weight"] < 1e-6


@pytest.mark.parametrize("run", ["free", "synced"])
def test_ci_job_series_match_round_by_round(replay, run):
    """Every round: the counts exact, the malicious weight within 1e-6 of
    the reference's."""
    import json
    _, summary, lines = replay
    for line in map(json.loads, lines[:-1]):
        got = line[run]
        assert got["parted"] is None and got["counts_differing"] == 0
        assert abs(got["malicious_weight"] - line["repro"]) < 1e-6
    assert len(summary["series"][run]) == ROUNDS
