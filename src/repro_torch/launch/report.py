"""Build the dry-run and roofline markdown tables from the dry-run
artifacts (``experiments/dryrun_torch/*.json``; the port's side of
``repro/launch/report.py``), headed for the H100 mesh the artifacts
name.

  PYTHONPATH=src python -m repro_torch.launch.report \\
      [--dir experiments/dryrun_torch] > roofline_torch.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.config import INPUT_SHAPES
from repro_torch.configs import get_config
from repro_torch.roofline import model_flops

DRYRUN_DIR = "experiments/dryrun_torch"
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_bytes(n):
    if n is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def fmt_s(x):
    return f"{x:.2e}"


def load_all(directory: str = DRYRUN_DIR):
    recs = {}
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def _shapes(recs):
    seen = {s for _, s, _ in recs}
    return [s for s in SHAPE_ORDER if s in seen] + sorted(
        seen - set(SHAPE_ORDER))


def dryrun_table(recs):
    lines = [
        "| arch | shape | mesh | status | chips | args/dev | temp/dev | "
        "trace | collectives |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    archs = sorted({a for a, _, _ in recs})
    for arch in archs:
        for shape in _shapes(recs):
            for mesh in ("single", "multi", "host"):
                r = recs.get((arch, shape, mesh))
                if r is None:
                    continue
                if r["status"] != "ok":
                    reason = r.get("reason", r.get("error", ""))[:60]
                    lines.append(f"| {arch} | {shape} | {mesh} | "
                                 f"{r['status']}: {reason} | | | | | |")
                    continue
                mem = r["memory"]
                colls = ", ".join(
                    f"{k}:{fmt_bytes(v)}"
                    for k, v in sorted(r["collectives"].items())) or "none"
                lines.append(
                    f"| {arch} | {shape} | {mesh} | ok | {r['num_chips']} "
                    f"| {fmt_bytes(mem['argument_bytes'])} "
                    f"| {fmt_bytes(mem['temp_bytes'])} "
                    f"| {r['trace_s']}s | {colls} |")
    return "\n".join(lines)


def roofline_table(recs, mesh: str = "single"):
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | bottleneck "
        "| MODEL_FLOPS | useful ratio | what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    hints = {
        ("memory", "train"): "increase arithmetic intensity: larger "
        "per-device batch, fuse optimizer, bf16 master weights",
        ("memory", "prefill"): "larger attention blocks / fused QKV to cut "
        "activation traffic",
        ("memory", "decode"): "batch more requests per card; quantise KV "
        "cache to int8",
        ("collective", "train"): "shard params less over data (less "
        "all-gather) or overlap collectives with compute",
        ("collective", "prefill"): "reduce tensor-parallel degree for "
        "short-seq layers; overlap all-gathers",
        ("collective", "decode"): "keep params model-sharded only "
        "(no FSDP regather); merge per-layer all-reduces",
        ("compute", "train"): "near roofline — only kernel-level wins left",
        ("compute", "prefill"): "near roofline — kernel-level wins",
        ("compute", "decode"): "near roofline",
    }
    archs = sorted({a for a, _, _ in recs})
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in _shapes(recs):
            r = recs.get((arch, shape_name, mesh))
            if r is None or r["status"] != "ok":
                continue
            shape = INPUT_SHAPES.get(shape_name)
            mf = model_flops(cfg, shape) if shape else r["model_flops_global"]
            kind = shape.kind if shape else ""
            useful = mf / r["num_chips"] / max(
                r["cost"]["flops_per_device"], 1.0)
            t = r["roofline"]
            hint = hints.get((t["bottleneck"], kind), "")
            lines.append(
                f"| {arch} | {shape_name} | {fmt_s(t['compute_s'])} "
                f"| {fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} "
                f"| **{t['bottleneck']}** | {mf:.2e} | {useful:.3f} "
                f"| {hint} |")
    return "\n".join(lines)


def _title(recs) -> str:
    """The single-pod mesh the artifacts ran on, by their records."""
    ok = [r for r in recs.values()
          if r["status"] == "ok" and r["mesh"] == "single"]
    if not ok:
        return "single-pod H100 baselines"
    return (f"single-pod {ok[0].get('chip', 'h100_sxm')} x "
            f"{ok[0]['num_chips']} baselines")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DRYRUN_DIR)
    args = ap.parse_args(argv)
    recs = load_all(args.dir)
    if not recs:
        print("no artifacts found", file=sys.stderr)
        return 1
    n_ok = sum(1 for r in recs.values() if r["status"] == "ok")
    n_skip = sum(1 for r in recs.values() if r["status"] == "skipped")
    n_err = sum(1 for r in recs.values() if r["status"] == "error")
    print(f"## Dry-run matrix ({n_ok} ok / {n_skip} skipped / "
          f"{n_err} error of {len(recs)} artifacts)\n")
    print(dryrun_table(recs))
    print(f"\n## Roofline ({_title(recs)})\n")
    print(roofline_table(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
