"""The reference CI's ``population-smoke`` job, seed by seed: each
round's malicious weight through the port (``chip_smoke.ci_population``,
``PopulationTrainer.run``) and, with ``--reference``, through the
reference's own command (``repro.launch.federated --population``, its
cohort sharded over 4 host-platform devices, as the CI runs it), beside
the CI's gate on the last round. One JSON line a run.

  PYTHONPATH=src python3 tools/population_ci_seeds.py --device cpu \\
      --seeds 0 1 2 --reference > cpu.jsonl
  python3 tools/population_ci_seeds.py --summarise cpu.jsonl

``--summarise`` reads such lines and prints, for each package and
device, how many seeds end below the gate, how many rounds from the
third on (and of the last three) reach it, and their mean.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402


def port_weights(device: str, seed: int):
    trainer, data = cs.ci_population(device, seed)
    _, hist = trainer.run(data)
    return [float(v) for v in hist["malicious_weight"]]


def reference_weights(seed: int, scratch: str):
    """The CI's command with ``--seed``; the weights are read from its
    round log, which it prints before anything after the rounds."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmd = [sys.executable, "-m", "repro.launch.federated", "--clients", "4",
           "--population", str(cs.CI_POPULATION),
           "--cohort", str(cs.CI_COHORT), "--rounds", str(cs.CI_ROUNDS),
           "--attack", "sign_flip", "--malicious", str(cs.CI_MALICIOUS),
           "--testers", str(cs.CI_TESTERS), "--testers-from-cohort",
           "--local-steps", str(cs.CI_STEPS), "--batch", str(cs.CI_BATCH),
           "--seed", str(seed), "--out", scratch]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True)
    weights = [float(m) for m in re.findall(r"mal_w=([0-9.]+)", out.stdout)]
    return weights, out.returncode


def summarise(paths) -> None:
    runs = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                run = json.loads(line)
                runs.setdefault((run["package"], run["device"]),
                                []).append(run["malicious_weight"])
    for (package, device), series in sorted(runs.items()):
        late = [w[2:] for w in series]
        last3 = [w[-3:] for w in series]
        print(json.dumps({
            "package": package, "device": device, "seeds": len(series),
            "last_below_gate": sum(w[-1] < cs.CI_GATE for w in series),
            "rounds_3_on": sum(map(len, late)),
            "rounds_3_on_at_gate": sum(v >= cs.CI_GATE
                                       for w in late for v in w),
            "mean_3_on": sum(map(sum, late)) / sum(map(len, late)),
            "last_3_rounds": sum(map(len, last3)),
            "last_3_at_gate": sum(v >= cs.CI_GATE
                                  for w in last3 for v in w),
            "mean_last_3": sum(map(sum, last3)) / sum(map(len, last3))}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--reference", action="store_true",
                    help="also run the reference's command for each seed")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "population_ci"),
                    help="where the reference's command writes its history")
    ap.add_argument("--summarise", nargs="+", metavar="JSONL",
                    help="summarise earlier runs' lines instead of running")
    args = ap.parse_args(argv)
    if args.summarise:
        summarise(args.summarise)
        return 0
    for seed in args.seeds:
        w = port_weights(args.device, seed)
        print(json.dumps({"package": "repro_torch", "device": args.device,
                          "seed": seed, "malicious_weight": w,
                          "below_gate": w[-1] < cs.CI_GATE}), flush=True)
        if args.reference:
            w, rc = reference_weights(seed, args.out)
            print(json.dumps({"package": "repro", "device": "cpu",
                              "seed": seed, "malicious_weight": w,
                              "rc": rc, "below_gate": bool(w)
                              and w[-1] < cs.CI_GATE}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
