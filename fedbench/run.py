"""Run one benchmark cell and print its result line.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Exits 2, printing no result, without a CUDA card or with fewer cards than
the cell asks for. The caches of the program's builds stay inside the
checkout (``.fedbench_cache/`` and the port's own ``kernels/_build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_environment(env: dict) -> None:
    """Fixed cache directories inside the checkout, then the cell's own
    variables; before torch is imported."""
    cache = os.path.join(ROOT, ".fedbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ.update({k: str(v) for k, v in env.items()})


def main(argv=None) -> int:
    args = parse_args(argv)
    path = os.path.join(ROOT, "fedbench", "workloads", f"{args.workload}.json")
    if not os.path.exists(path):
        print(f"no workload file {path}", file=sys.stderr)
        return 2
    with open(path) as f:
        set_environment(json.load(f).get("env", {}))
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from fedbench import harness
    return harness.main(args, ROOT, T_START)


if __name__ == "__main__":
    sys.exit(main())
