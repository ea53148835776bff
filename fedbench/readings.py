"""The readings the limits of ``correct`` are set from, on the card at
a cell's own size:

    python3 fedbench/readings.py --workload fedtest-cnn.dense-n20 \\
        --seeds 101 102 ... --control-seeds 201 202 203 \\
        --faults half_batch answer_altered state_unchanged

* sound runs: the program's checked rounds (the window's own call, as a
  run's set-up makes them) against the reference, one line a seed;
* the control: the reference computed one precision below the
  configuration's (``control`` in the configuration file: TF32 for
  float32) put in the program's place;
* faults planted in the program (``FAULTS``), each a line a seed;
* a probe: the reference in another precision (``--probe``, bfloat16 by
  default) in the program's place, to show how far that precision alone
  parts a run from float32.

``--explain`` adds, to standard error, what a leaf's gap of change is
made of: every leaf's norm of change on both sides and its gap, and each
round's weights by the program and by the reference.

Each line is JSON: ``{"kind", "seed", "numbers"}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def half_batch(program) -> None:
    """Local training on half of each batch, its loss the mean over it."""
    rp = program.trainer.program
    train = rp.local_train

    def half(params, bx, by):
        b = bx.shape[1] // 2
        return train(params, bx[:, :b], by[:, :b])
    rp.local_train = half


def answer_altered(program) -> None:
    """One cross-test accuracy a round moved by a half."""
    import torch
    backend = program.backend
    cross_test = backend.cross_test

    def altered(*a, **k):
        acc = cross_test(*a, **k).clone()
        acc[0, 0] = torch.where(acc[0, 0] < 0.5, acc[0, 0] + 0.5,
                                acc[0, 0] - 0.5)
        return acc
    backend.cross_test = altered


def weights_altered(program) -> None:
    """The scoring's weights altered where they are made: every other
    client's weight half as large again, renormalised."""
    import torch
    agg = program.trainer.program.aggregator
    weights = agg.weights

    def altered(ctx):
        w = weights(ctx)
        odd = torch.arange(w.numel(), device=w.device) % 2 == 0
        w = w * (1.0 + 0.5 * odd.float())
        return w / w.sum()
    agg.weights = altered


def state_unchanged(program) -> None:
    """The round hands back the global model it was given."""
    program.backend.weighted_sum = (
        lambda models, weights, global_params: global_params)


FAULTS: Dict[str, Callable] = {"half_batch": half_batch,
                               "answer_altered": answer_altered,
                               "state_unchanged": state_unchanged,
                               "weights_altered": weights_altered}


def explain() -> Callable:
    """Log the leaf gaps of change and the reference's weights a round;
    returns a plant that logs the program's weights a round."""
    from fedbench import harness
    from fedbench.reference import compare

    def log(**k):
        print(json.dumps(k), file=sys.stderr, flush=True)

    gaps = compare.leaf_gaps

    def logged_gaps(prog, ref, first):
        out = gaps(prog, ref, first)
        log(leaf_gaps={k: [prog[k], ref[k], out.get(k)] for k in ref})
        return out
    compare.leaf_gaps = logged_gaps
    rounds = harness.reference_rounds

    def logged_rounds(*a, **k):
        recs, model, data = rounds(*a, **k)
        log(reference_weights=[r["weights"].tolist() for r in recs])
        return recs, model, data
    harness.reference_rounds = logged_rounds

    def plant(program) -> None:
        backend = program.backend
        weighted_sum = backend.weighted_sum

        def logged(models, weights, global_params):
            log(program_weights=weights.float().tolist())
            return weighted_sum(models, weights, global_params)
        backend.weighted_sum = logged
    return plant


def program_numbers(cell, seed: int, device, plant=None) -> Dict[str, float]:
    from fedbench import harness
    program, params0 = harness.build(cell, seed, device)
    if plant is not None:
        plant(program)
    checked = harness.checked_rounds(program, params0,
                                     cell.traffic["checked_rounds"])
    del program, params0
    harness.free(device)
    return harness.judge(cell, seed, device, checked)


def control_numbers(cell, seed: int, device, precision=None
                    ) -> Dict[str, float]:
    """The numbers of the reference in the control's precision, or in
    ``precision`` (a probe), put in the program's place."""
    from fedbench import harness
    return harness.judge(cell, seed, device,
                         harness.control_record(cell, seed, device,
                                                precision))


def _both(first, second) -> Callable:
    def plant(program) -> None:
        for p in (first, second):
            if p is not None:
                p(program)
    return plant


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--probe", default="bfloat16",
                    help="a precision to run the reference in beside the "
                         "control, in the program's place")
    ap.add_argument("--probe-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--explain", action="store_true",
                    help="log each leaf's gap of change and the weights")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from fedbench import run
    with open(os.path.join(ROOT, "fedbench", "workloads",
                           f"{args.workload}.json")) as f:
        run.set_environment(json.load(f).get("env", {}))
    import torch
    from fedbench import harness
    from repro_torch.core.engine.driver import resolve_device

    device = resolve_device(args.device)
    cell = harness.Cell(ROOT, args.workload)
    runs = ([("sound", s, None) for s in args.seeds]
            + [(f"fault:{f}", s, FAULTS[f]) for f in args.faults
               for s in args.fault_seeds])
    logged = explain() if args.explain else None
    for kind, seed, plant in runs:
        if logged is not None:
            plant = _both(plant, logged)
        nums = program_numbers(cell, seed, device, plant)
        print(json.dumps({"kind": kind, "seed": seed, "numbers": nums}),
              flush=True)
    for seed in args.control_seeds:
        print(json.dumps({"kind": f"control:{cell.config['control']}",
                          "seed": seed,
                          "numbers": control_numbers(cell, seed, device)}),
              flush=True)
    for seed in args.probe_seeds:
        print(json.dumps({"kind": f"probe:{args.probe}", "seed": seed,
                          "numbers": control_numbers(cell, seed, device,
                                                     args.probe)}),
              flush=True)
    if device.type == "cuda":
        print(f"peak {torch.cuda.max_memory_allocated()} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
