"""The program's own spans and counters (``repro_torch.tracing``) in a
cell, and what the per-layer metrics of them read.

A traced run would take them in three steps: tracing on from before the
kernels load until the checked rounds end, exported as
``record["program_setup"]`` (so a chunk's capture holds the round's
event nodes); off for the window and the profiled stretch (the profiler
still records the spans' annotations); and on for ``timer_plays`` plays
after the step timers (:func:`traced_plays`), exported as
``record["program"]``. Both print through :func:`summary`, as
``program_setup:`` and ``program:`` lines. ``harness.run`` takes none of
them yet (PERF.md, Open questions). :func:`main` takes them for one cell
on the card, and measures what tracing costs the window, in alternating
windows of one process:

    python3 fedbench/program_spans.py --workload fedtest-cnn.dense-n20 \\
        --seed 7 --seconds 10 --repeats 2

A reader that finds no span to read returns ``None``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ reading
def _spans(export: Optional[dict], name: str, replay: bool) -> List[dict]:
    return [s for s in (export or {}).get("spans", ())
            if s["name"] == name and s["replay"] == replay]


def round_sums(export: Optional[dict], name: str, field: str = "device_ms",
               replay: bool = False) -> Dict[object, float]:
    """For each round that has spans ``name`` (a replay's copies where
    ``replay``), the sum of their ``field``; a round where any of them
    lacks it is left out."""
    sums: Dict[object, list] = collections.defaultdict(list)
    for s in _spans(export, name, replay):
        sums[s["round"]].append(s[field])
    return {r: sum(v) for r, v in sums.items() if None not in v}


def round_median(export: Optional[dict], name: str,
                 field: str = "device_ms", replay: bool = False
                 ) -> Optional[float]:
    """The median over rounds of :func:`round_sums`, or ``None``."""
    sums = round_sums(export, name, field, replay)
    return statistics.median(sums.values()) if sums else None


def span_median(export: Optional[dict], name: str, field: str = "host_ms"
                ) -> Optional[float]:
    """The median ``field`` of the eager spans ``name``, or ``None``."""
    values = [s[field] for s in _spans(export, name, False)
              if s[field] is not None]
    return statistics.median(values) if values else None


def summary(export: Optional[dict], round_idx=None) -> dict:
    """Each span name's calls and summed host and device ms (a replay's
    copies under ``<name>@replay``), of round ``round_idx`` alone if
    given; and the counters."""
    out: Dict[str, dict] = {}
    for s in (export or {}).get("spans", ()):
        if round_idx is not None and s["round"] != round_idx:
            continue
        key = s["name"] + ("@replay" if s["replay"] else "")
        row = out.setdefault(key, {"calls": 0, "host_ms": 0.0,
                                   "device_ms": 0.0})
        row["calls"] += 1
        for f in ("host_ms", "device_ms"):
            if s[f] is not None:
                row[f] += s[f]
    return {"spans": out, "counters": (export or {}).get("counters", {})}


# ------------------------------------------------------------------ running
def traced_plays(program, plays: int) -> dict:
    """``plays`` plays of the window's call with the program's tracing
    on; what they recorded (``tracing.export``)."""
    from repro_torch import tracing
    tracing.export()
    tracing.enable()
    try:
        for _ in range(plays):
            program.play()
    finally:
        tracing.enable(False)
    return tracing.export()


def _window(program, seconds: float, traced: bool) -> dict:
    from fedbench import harness
    from repro_torch import tracing
    tracing.enable(traced)
    try:
        win_s, times, _ = harness.window(program.play, seconds,
                                         program.rounds_per_play)
    finally:
        tracing.enable(False)
    kept = len(tracing.export()["spans"])
    rounds = len(times) * program.rounds_per_play
    return {"traced": traced, "rounds": rounds, "spans": kept,
            "round_ms": 1e3 * win_s / rounds}


def _built(cell, seed: int, device, traced: bool):
    """The program after its checked rounds, with tracing on through
    them or not; and what tracing recorded."""
    from fedbench import harness
    from repro_torch import tracing
    tracing.enable(traced)
    try:
        program, params0 = harness.build(cell, seed, device)
        harness.checked_rounds(program, params0,
                               cell.traffic["checked_rounds"])
        harness._sync(device)
    finally:
        tracing.enable(False)
    return program, tracing.export()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="each window's seconds")
    ap.add_argument("--repeats", type=int, default=2,
                    help="times the windows' order (off, on, on, off) runs")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from fedbench import run
    with open(os.path.join(ROOT, "fedbench", "workloads",
                           f"{args.workload}.json")) as f:
        run.set_environment(json.load(f).get("env", {}))
    import torch
    from fedbench import harness
    from repro_torch import tracing
    from repro_torch.core.engine.driver import resolve_device

    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = resolve_device("cuda")
    torch.cuda.init()
    cell = harness.Cell(ROOT, args.workload)
    tracing.enable()
    from repro_torch.kernels.build import load_library
    for k in cell.workload.get("kernels", []):
        load_library(k)
    tracing.enable(False)
    kernels = tracing.export()
    t = time.perf_counter()
    program, setup = _built(cell, args.seed, device, True)
    print(f"program_setup: {time.perf_counter() - t:.3f} s; kernels "
          + json.dumps(summary(kernels)) + "; first round "
          + json.dumps(summary(setup, 0)) + "; all "
          + json.dumps(summary(setup)), flush=True)

    # a chunk's capture holds event nodes where tracing was on through
    # it: a twin captured with tracing off prices them
    twin = None
    if program.rounds_per_play > 1:
        twin, _ = _built(cell, args.seed, device, False)
    plan = [(program, False), (program, True), (program, True),
            (program, False)]
    if twin is not None:
        plan = [(twin, False)] + plan + [(twin, False)]
    plan = plan * args.repeats
    rows = []
    for prog, traced in plan:
        row = _window(prog, args.seconds, traced)
        row["graph_events"] = prog is program and twin is not None
        rows.append(row)
        print("window: " + json.dumps(row), flush=True)

    def mean(pred):
        ms = [r["round_ms"] for r in rows if pred(r)]
        return sum(ms) / len(ms)
    off = mean(lambda r: not r["traced"] and r["graph_events"] == bool(twin))
    cost = {"traced_over_untraced": mean(lambda r: r["traced"]) / off - 1}
    if twin is not None:
        cost["graph_events_over_none"] = off / mean(
            lambda r: not r["graph_events"]) - 1
    print("cost: " + json.dumps(cost), flush=True)

    record = {"program": traced_plays(program,
                                      cell.traffic["timer_plays"]),
              "program_setup": setup}
    print("program: " + json.dumps(summary(record["program"])), flush=True)
    names = ("update_ms", "step_host_ms", "draw_ms", "shards_ms",
             "noise_ms")
    values = {}
    for name in names:
        values[name] = cell.reader(name)(record)
    # a replayed round's draw, shards and noise against the replay's own
    # device time
    replay = round_sums(record["program"], "replay")
    parts = [round_sums(record["program"], n, replay=True)
             for n in ("draw", "shards", "noise")]
    values["replays"] = {
        str(r): {"replay_device_ms": replay[r],
                 "draw_shards_noise_ms": sum(p.get(r, 0.0) for p in parts)}
        for r in sorted(set().union(*parts)) if r in replay}
    print(f"card: {harness.power_limit()}")
    print("readers: " + json.dumps(values), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
