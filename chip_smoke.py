#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository; it needs one CUDA card and the CUDA
toolkit (``nvcc``), and exits non-zero on the first phase that fails.

1. Environment: the card's name and power limit, the CUDA version and
   both TF32 flags (off: the port runs fp32 models in full fp32).
2. Every kernel of the main path is built from ``src/repro_torch/kernels/
   csrc`` and held against its plain PyTorch version on the card.
3. Times, with CUDA events: each kernel at the shapes the main path gives
   it, beside its plain version, one PyTorch library call computing the
   same function, and the least time the card could take (its bound).
   Each is timed twice: on the device alone (the calls captured in a CUDA
   graph and replayed, so no host work sits between them) and eagerly
   (back-to-back calls from Python, host dispatch included). One JSON
   line ``{"kernels": [...]}`` carries them.
4. The main path: three rounds of the paper's FedTest round at the full
   width of ``fedtest-cnn`` (188,810 params; 20 users, 5 testers, 3
   ``random_weights`` attackers), built by ``repro_torch.launch.train``'s
   code path on ``cuda``. Every value must be finite, the weights must
   sum to 1, and the kernel launch counts must show the rounds went
   through the kernels.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 3
MAIN_PATH_ARGS = [
    "--device", "cuda", "--arch", "fedtest-cnn", "--dataset", "cifar_like",
    "--samples", "20000", "--users", "20", "--testers", "5",
    "--malicious", "3", "--attack", "random_weights",
    "--aggregator", "fedtest", "--selector", "rotating",
    "--local-steps", "10", "--batch", "32", "--lr", "0.05",
    "--optimizer", "sgd", "--rounds", str(ROUNDS)]

# published peaks by card (NVIDIA data sheets, dense): HBM bytes/s and
# fp32 FLOP/s outside the tensor cores
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


def check(cond, what) -> None:
    """Fail the run (also under ``python -O``, which drops asserts)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no published peaks for card {name!r}")


def _events(torch, run, reps: int) -> float:
    """Milliseconds of ``reps`` calls of ``run``, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def eager_ms(torch, fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls from Python:
    where a call's device work is shorter than its host dispatch, this is
    the host's time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _events(torch, fn, iters) / iters


def graph_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Mean device time of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times, so no host work sits between the
    launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events(torch, graph.replay, replays) / (replays * iters)


def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.core.engine import resolve_device
    resolve_device("cuda")
    print(smi)          # the card's name and power limit, as nvidia-smi says
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    return smi


def phase_kernel_checks(torch):
    """Build the kernel, then hold it against its plain version."""
    from repro_torch.kernels import build
    from repro_torch.kernels.weighted_aggregate import (
        weighted_aggregate, weighted_aggregate_ref)
    t0 = time.perf_counter()
    lib = build.build("weighted_aggregate")
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s; nvcc says:")
    print(lib.with_suffix(".log").read_text().strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    launches = weighted_aggregate.launches
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        for C in (1, 3, 16, 20):
            for M in (1, 10, 1000, 131072, 1 << 22):
                x = torch.randn((C, M), generator=gen,
                                device="cuda").to(dtype)
                w = torch.rand((C,), generator=gen, device="cuda")
                # a 4-byte-offset copy takes the unaligned scalar path
                shifted = torch.empty(C * M + 1, dtype=dtype,
                                      device="cuda")[1:].view(C, M)
                shifted.copy_(x)
                for xin in (x, shifted):
                    got = weighted_aggregate(xin, w)
                    want = weighted_aggregate_ref(xin, w)
                    torch.cuda.synchronize()
                    check(got.dtype == dtype and got.shape == (M,),
                          f"output {got.dtype} {tuple(got.shape)}")
                    torch.testing.assert_close(got.float(), want.float(),
                                               rtol=tol, atol=tol)
                    err = float((got.float() - want.float()).abs().max())
                    worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    check(weighted_aggregate.launches == launches + 80,
          "one launch counted per kernel call")
    transposed = torch.zeros((8, 3), device="cuda").t()
    try:
        weighted_aggregate(transposed, torch.zeros((3,), device="cuda"))
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: a non-contiguous CUDA input "
                           "must be refused")
    print(f"weighted_aggregate == plain version in 80 cases "
          f"(f32 rtol=atol=1e-5, bf16 rtol=atol=8e-3); max |err| {worst}; "
          f"a non-contiguous input is refused")


def phase_times(torch, hbm, flops_peak, main_path_leaves):
    """Kernel, plain version, torch.mv and bound at the main path's leaf
    shapes (C=20, f32) and at C=20, M=2**22: ``*_ms`` on the device alone
    (CUDA graph), ``*_eager_ms`` with the host's dispatch."""
    from repro_torch.kernels.weighted_aggregate import (
        weighted_aggregate, weighted_aggregate_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for M in list(main_path_leaves) + [1 << 22]:
        C = 20
        x = torch.randn((C, M), generator=gen, device="cuda")
        w = torch.rand((C,), generator=gen, device="cuda")
        err = float((weighted_aggregate(x, w)
                     - weighted_aggregate_ref(x, w)).abs().max())
        iters = 50 if M >= 1 << 20 else 200
        bytes_moved = (C * M + M) * 4 + C * 4
        row = {"name": "weighted_aggregate", "shape": [C, M],
               "dtype": "float32", "max_abs_err": err,
               "bound_ms": max(bytes_moved / hbm,
                               2 * C * M / flops_peak) * 1e3}
        for key, fn in (("kernel", lambda: weighted_aggregate(x, w)),
                        ("plain", lambda: weighted_aggregate_ref(x, w)),
                        ("library", lambda: torch.mv(x.t(), w))):
            row[key + "_ms"] = graph_ms(torch, fn, iters)
            row[key + "_eager_ms"] = eager_ms(torch, fn, iters)
        rows.append(row)
    return rows


def phase_main_path(torch):
    """Three full-width rounds through the launcher's code path."""
    from repro_torch.kernels.weighted_aggregate import (
        weighted_aggregate, weighted_aggregate_ref)
    from repro_torch.launch.train import build, parse_args
    from repro_torch.utils import tree_leaves

    t0 = time.perf_counter()
    trainer, data, cfg = build(parse_args(MAIN_PATH_ARGS))
    state = trainer.init()
    n_params = trainer.model.param_count(state.global_params)
    print(f"main path: {cfg.name} ({n_params:,} params), "
          f"{trainer.fed.num_users} users, {trainer.fed.num_testers} "
          f"testers, malicious "
          f"{trainer.attack.malicious_indices(trainer.fed.num_users)}; "
          f"set-up {time.perf_counter() - t0:.1f} s")
    check(n_params == 188_810, f"fedtest-cnn has {n_params} params")

    # time each backend step of the round (host clock between two
    # synchronisations, so a step's time includes its launch overhead),
    # and keep step 7's inputs of the last round, to hold the kernel's
    # aggregate against the plain version on exactly what it was given
    step_ms, seen = {}, {}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            step_ms[name] = (time.perf_counter() - t) * 1e3
            if name == "aggregate":
                seen["models"], seen["weights"], seen["out"] = (
                    args[0], args[1], out)
            return out
        return run

    backend = trainer.backend
    for name, method in (("train", "train"), ("attack", "apply_attack"),
                         ("cross_test", "cross_test"),
                         ("aggregate", "weighted_sum")):
        setattr(backend, method, timed(name, getattr(backend, method)))

    torch.cuda.synchronize()
    weighted_aggregate.launches = 0
    walls = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        state, metrics = trainer.run_round(state, data)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        rest = walls[-1] - sum(step_ms.values())
        print(f"round {state.round_idx} steps ms: " + "  ".join(
            f"{k} {v:.3f}" for k, v in step_ms.items())
            + f"  rest {rest:.3f}")
        acc = trainer.global_accuracy(state, data)
        w = metrics["weights"]
        values = [float(metrics["local_loss"]),
                  float(metrics["malicious_weight"]), acc]
        check(all(math.isfinite(v) for v in values),
              f"finite loss, malicious weight, accuracy: {values}")
        check(bool(torch.isfinite(w).all()), f"finite weights {w}")
        check(abs(float(w.sum()) - 1.0) < 1e-5,
              f"weights sum to 1: {float(w.sum())}")
        check(all(bool(torch.isfinite(p).all())
                  for p in tree_leaves(state.global_params)),
              "finite global params")
        print(f"round {state.round_idx}: wall {walls[-1]:.1f} ms  "
              f"local_loss {values[0]:.4f}  malicious_weight "
              f"{values[1]:.5f}  global_acc {acc:.4f}  weights "
              f"[{' '.join(f'{v:.4f}' for v in w.tolist())}]")
    launches = weighted_aggregate.launches
    n_leaves = len(tree_leaves(state.global_params))
    check(launches == n_leaves * ROUNDS,
          f"{launches} weighted_aggregate launches, want {n_leaves} leaves "
          f"x {ROUNDS} rounds")
    print(f"weighted_aggregate launches in the main path: {launches} "
          f"({n_leaves} leaves x {ROUNDS} rounds)")

    worst = 0.0
    for got, stack in zip(tree_leaves(seen["out"]),
                          tree_leaves(seen["models"])):
        flat = stack.reshape(stack.shape[0], -1)
        want = weighted_aggregate_ref(flat, seen["weights"])
        torch.testing.assert_close(got.reshape(-1), want, rtol=1e-5,
                                   atol=1e-6)
        worst = max(worst, float((got.reshape(-1) - want).abs().max()))
    print(f"last round's aggregate == plain version on its own inputs "
          f"(max |err| {worst:.3g})")
    return launches, walls


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no port package under {src}; run this script "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves

    t_start = time.perf_counter()
    card = phase_environment(torch)
    _, (hbm, flops_peak) = card_peaks(torch.cuda.get_device_name(0))
    phase_kernel_checks(torch)
    # the main path's aggregation: one launch per param leaf, C = users
    leaves = [math.prod(s) for s in tree_leaves(
        build_model(get_config("fedtest-cnn")).param_shapes())]
    rows = phase_times(torch, hbm, flops_peak, leaves)
    main_rows = rows[:len(leaves)]
    launches, walls = phase_main_path(torch)

    def total(key):
        return sum(r[key] for r in main_rows)

    print(f"round wall ms: {[round(t, 3) for t in walls]} ({card})")
    print(json.dumps({"kernels": [{
        "name": "weighted_aggregate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/weighted_aggregate.cu",
        "replaces": "src/repro/kernels/weighted_aggregate/kernel.py:33",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        # one round's aggregation: the 10 leaf launches at C=20
        "shape": "C=20, one launch per leaf, M=" + "+".join(
            str(m) for m in leaves),
        "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "bytes", "library_ms": total("library_ms"),
        "eager_ms": total("kernel_eager_ms"),
        "plain_eager_ms": total("plain_eager_ms"),
        "library_eager_ms": total("library_eager_ms"),
        "card": card, "shapes": rows}]}))
    print(f"chip_smoke passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
