"""The pod CLI of the port (``python -m repro_torch.launch.federated``) on
the CPU: the reference CI's ``pod-smoke`` commands (the ring with a
sign_flip attacker; the all-gather with client sampling) and a small
population run with its cohort sharded over the ranks, each exiting 0
and writing the reference's JSON keys; the three commands run at once.
Then the refusals: nccl for ranks on the CPU, the card where there is
none, a cohort the ranks do not divide.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the keys of the reference's {dataset}__{exchange}.json and its config
POD_KEYS = {"round", "acc", "local_loss", "malicious_weight",
            "participation_rate", "dropped_fraction", "wall_s", "config"}
POD_CONFIG = {"clients", "aggregator", "attack", "malicious",
              "attack_scale", "participation", "coalition",
              "coalition_size", "fault", "fault_rate", "compressor",
              "scenario", "exchange"}
POPULATION_KEYS = {"round", "global_accuracy", "local_loss",
                   "malicious_weight", "wall_s", "config"}
RUNS = {
    "ring": (["--clients", "4", "--rounds", "2", "--attack", "sign_flip",
              "--malicious", "1"], "mnist_like__ring.json"),
    "allgather": (["--clients", "4", "--rounds", "2", "--exchange",
                   "allgather", "--attack", "sign_flip", "--malicious",
                   "1", "--participation", "0.75"],
                  "mnist_like__allgather.json"),
    "population": (["--clients", "4", "--population", "64", "--cohort",
                    "8", "--rounds", "2", "--testers", "4",
                    "--testers-from-cohort", "--attack", "sign_flip",
                    "--malicious", "13", "--local-steps", "2"],
                   "mnist_like__population.json"),
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for name, (argv, _) in RUNS.items():
        out = str(tmp_path_factory.mktemp(name))
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.federated",
             "--device", "cpu", "--out", out] + argv, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    done = {}
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        done[name] = (proc.returncode, stdout, stderr, out)
    return done


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_runs_and_writes_the_references_keys(cli_runs, name):
    rc, stdout, stderr, out = cli_runs[name]
    assert rc == 0, stderr[-3000:]
    with open(os.path.join(out, RUNS[name][1])) as f:
        history = json.load(f)
    rounds = 2
    if name == "population":
        assert set(history) == POPULATION_KEYS
        assert history["config"]["devices"] == 4
    else:
        assert set(history) == POD_KEYS
        assert POD_CONFIG <= set(history["config"])
        assert history["config"]["exchange"] == name
        assert f"round {rounds}: global_acc=" in stdout
    assert "transport gloo" in stdout.splitlines()[0]
    assert history["round"] == [1, 2]
    assert all(0.0 <= w <= 1.0 for w in history["malicious_weight"])


@pytest.mark.parametrize("argv,exc,match", [
    (["--device", "cpu", "--dist-backend", "nccl"], ValueError,
     "needs CUDA"),
    (["--device", "cpu", "--clients", "3", "--population", "64",
      "--cohort", "8"], SystemExit, "divide evenly"),
    (["--device", "cpu", "--population", "64"], SystemExit,
     "requires --cohort"),
])
def test_cli_refusals(argv, exc, match):
    from repro_torch.launch.federated import main
    with pytest.raises(exc, match=match):
        main(argv)


def test_cli_raises_without_a_card():
    """``--device cuda`` (the default) refuses a machine with no card
    before it starts a rank."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.launch.federated import main
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--clients", "4"])
