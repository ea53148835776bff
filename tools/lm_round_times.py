"""Phase L of ``chip_smoke.py`` (the LM round on qwen2-0.5b at full width
and depth, through the train launcher), checkout by checkout, each in a
process of its own, in the order given: the rounds' wall times and their
split by step, to compare two trees on one card (run parent, change,
change, parent).

  git archive <commit> | tar -x -C .checkout/parent
  python3 tools/lm_round_times.py --trees .checkout/parent . . \\
      .checkout/parent --rounds 5

Each tree runs its own ``chip_smoke.phase_lm`` with its own package and
kernels (built there at first use), so every check of the phase holds,
on the allocator's expandable segments as ``chip_smoke.py`` runs it.
Prints each run's round lines, one JSON line a run, and a summary of the
steady rounds (all but the first) by tree.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG = "lm_round_times: "
CHILD = """
import json, os, sys
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
tree, rounds = sys.argv[1], int(sys.argv[2])
sys.path[:0] = [tree, tree + '/src']
import torch, chip_smoke as cs
cs.LM_ROUNDS = rounds
card = cs.phase_environment(torch)
label, argv, op_name, layers = cs.LM_PHASES[0]
out = cs.phase_lm(torch, card, label, argv, op_name, layers)
print(sys.argv[3] + json.dumps({"card": card, "wall_ms": out["wall_ms"],
                                "peak_bytes": out["peak_bytes"]}))
"""
ROUND = re.compile(r"phase L round \d+: wall ([0-9.]+) ms \((.*?)\)")


def run_tree(tree: str, rounds: int) -> dict:
    tree = os.path.abspath(os.path.join(ROOT, tree))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, tree, str(rounds), TAG], cwd=tree,
        capture_output=True, text=True, timeout=900)
    result, steps = None, []
    for line in proc.stdout.splitlines():
        if line.startswith(TAG):
            result = json.loads(line[len(TAG):])
        elif ROUND.search(line):
            print(line)
            split = ROUND.search(line).group(2)
            steps.append({k: float(v) for k, v in
                          re.findall(r"(\w+) ([0-9.]+)", split)})
    if proc.returncode != 0 or result is None:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    result.update(tree=os.path.relpath(tree, ROOT), steps=steps)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="checkouts, relative to the repo's root")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    runs = []
    for tree in args.trees:
        runs.append(run_tree(tree, args.rounds))
        print(TAG + json.dumps(runs[-1]), flush=True)
    for tree in dict.fromkeys(r["tree"] for r in runs):
        mine = [r for r in runs if r["tree"] == tree]
        walls = [w for r in mine for w in r["wall_ms"][1:]]
        train = [s["train"] for r in mine for s in r["steps"][1:]]
        print(f"{tree}: {len(mine)} runs, steady rounds {len(walls)}: wall "
              f"median {statistics.median(walls):.1f} ms (min "
              f"{min(walls):.1f}, max {max(walls):.1f}); train median "
              f"{statistics.median(train):.1f} ms (min {min(train):.1f}, "
              f"max {max(train):.1f}); {mine[0]['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
