#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository; it needs one CUDA card and the CUDA
toolkit (``nvcc``), and exits non-zero on the first phase that fails.

1. Environment: the card's name and power limit, the CUDA version and
   both TF32 flags (off: the port runs fp32 models in full fp32).
2. Every kernel of the port is built from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, all at once) and held against its
   plain PyTorch version on the card; bad inputs must be refused.
3. Times, with CUDA events: each kernel at the shapes its path gives it
   and at M=2**22, beside its plain version, one PyTorch library call
   computing the same function, and the least time the card could take
   (its bound). Each is timed twice: on the device alone (the calls
   captured in a CUDA graph and replayed, so no host work sits between
   them) and eagerly (back-to-back calls from Python, host dispatch
   included). One JSON line ``{"kernels": [...]}`` carries them.
4. Three paths, three rounds each, of the paper's FedTest round at the
   full width of ``fedtest-cnn`` (188,810 params; 20 users, 5 testers, 3
   ``random_weights`` attackers), built by ``repro_torch.launch.train``'s
   code path on ``cuda``: A, the paper's score-weighted sum
   (``weighted_aggregate``); B, the coordinate-wise trimmed mean
   (``robust_combine``); C, the int8 compressed exchange
   (``dequant_aggregate``). Every value must be finite, the weights must
   sum to 1, the launch counts must show each path went through its
   kernel and no other, and the last step-7 output must equal the plain
   version's on the same inputs.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import re
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
TRIM = 0.2
# (path, CLI arguments, the kernel op the path must launch)
PATHS = (
    ("A", MAIN_PATH_ARGS, "weighted_aggregate"),
    ("B", MAIN_PATH_ARGS + [
        "--aggregator", "trimmed_mean_coord", "--agg-kwargs",
        json.dumps({"trim_fraction": TRIM, "score_gate": 0.5})],
     "robust_combine"),
    ("C", MAIN_PATH_ARGS + ["--compressor", "int8"], "dequant_aggregate"),
)
KERNELS = ("weighted_aggregate", "robust_combine", "dequant_aggregate")
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in KERNELS}
REPLACES = {
    "weighted_aggregate": "src/repro/kernels/weighted_aggregate/kernel.py:33",
    "robust_combine": "src/repro/kernels/robust_combine/kernel.py:94",
    "dequant_aggregate": "src/repro/kernels/dequant_aggregate/kernel.py:52",
}

# published peaks by card (NVIDIA data sheets, dense): HBM bytes/s and
# fp32 FLOP/s outside the tensor cores
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


def check(cond, what) -> None:
    """Fail the run (also under ``python -O``, which drops asserts)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def must_raise(exc, fn, what) -> None:
    try:
        fn()
    except exc:
        return
    raise RuntimeError(f"check failed: {what} must raise {exc.__name__}")


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no published peaks for card {name!r}")


def ops():
    """The three kernel ops, by name."""
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate
    from repro_torch.kernels.robust_combine import robust_combine
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate
    return {"weighted_aggregate": weighted_aggregate,
            "robust_combine": robust_combine,
            "dequant_aggregate": dequant_aggregate}


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


def phase_build():
    """Build every kernel, one nvcc each, all started together; print
    nvcc's register and spill report. robust_combine has one kernel per
    C = 1..64 (and a 4-column one for C <= 32): its report is summed up,
    and the C=20 kernels the paths use must not spill."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    print(f"built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    prop = re.compile(r"Function properties for (\S+)\s+(\d+) bytes stack "
                      r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads\s+ptxas info\s+: Used (\d+) registers")
    for name, lib in libs.items():
        report = prop.findall(lib.with_suffix(".log").read_text())
        check(report, f"nvcc's -Xptxas -v report for {name}")
        print(f"{os.path.relpath(lib, ROOT)}: {len(report)} kernels")
        for fn, stack, stores, loads, regs in report:
            if name != "robust_combine" or "ILi20E" in fn or int(stores):
                print(f"  {fn}: {regs} registers, {stack} bytes stack, "
                      f"{stores} bytes spill stores, {loads} bytes spill "
                      f"loads")
        if name == "robust_combine":
            spills = [(fn, int(s), int(l)) for fn, _, s, l, _ in report
                      if int(s) or int(l)]
            c20 = [fn for fn, *_ in report if "ILi20E" in fn]
            check(len(c20) == 2 and not any(fn in c20 for fn, *_ in spills),
                  f"robust_combine at C=20 spills: {spills}")
            print(f"  robust_combine: {len(spills)} of {len(report)} "
                  f"kernels spill; max registers "
                  f"{max(int(r[-1]) for r in report)}")


def _shifted(torch, x, offset_bytes: int):
    """A copy of ``x`` whose data starts ``offset_bytes`` past an aligned
    address: it drives a kernel's unaligned path."""
    n = offset_bytes // x.element_size()
    buf = torch.empty(x.numel() + n, dtype=x.dtype, device=x.device)
    out = buf[n:].view(x.shape)
    out.copy_(x)
    return out


def check_weighted_aggregate(torch):
    from repro_torch.kernels.weighted_aggregate import (
        weighted_aggregate, weighted_aggregate_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    launches = weighted_aggregate.launches
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        for C in (1, 3, 16, 20):
            for M in (1, 10, 1000, 131072, 1 << 22):
                x = torch.randn((C, M), generator=gen,
                                device="cuda").to(dtype)
                w = torch.rand((C,), generator=gen, device="cuda")
                for xin in (x, _shifted(torch, x, 4)):
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
    must_raise(ValueError, lambda: weighted_aggregate(
        transposed, torch.zeros((3,), device="cuda")),
        "a non-contiguous CUDA input")
    print(f"weighted_aggregate == plain version in 80 cases "
          f"(f32 rtol=atol=1e-5, bf16 rtol=atol=8e-3); max |err| {worst}; "
          f"a non-contiguous input is refused")


def check_robust_combine(torch):
    """Batcher sort + sorted-position dot against the plain network, at
    rtol=atol=1e-6: the sorted values are exact and the dot is taken in
    the plain version's order."""
    from repro_torch.kernels.robust_combine import (
        MAX_CLIENTS, combine_rows, robust_combine,
        robust_combine_network_ref, row_select_weights)
    gen = torch.Generator(device="cuda").manual_seed(2)
    modes = (("trimmed_mean", 0.0), ("trimmed_mean", 0.2),
             ("trimmed_mean", 0.49), ("median", 0.0))
    calls, worst = 0, 0.0
    launches = robust_combine.launches

    def hold(x, mask, mode, trim):
        nonlocal calls, worst
        w_row = row_select_weights(mask, mode=mode, trim_fraction=trim)
        got = combine_rows(x, mask, w_row)
        want = robust_combine_network_ref(x, mask, w_row)
        torch.cuda.synchronize()
        calls += 1
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)
        diff = (got - want).abs()
        worst = max(worst, float(diff[~diff.isnan()].max())
                    if diff.numel() else 0.0)
        return got

    for C in (1, 2, 3, 5, 16, 20, 32, 64):
        for M in (1, 10, 1000, 188_810, 1 << 22):
            x = torch.randn((C, M), generator=gen, device="cuda")
            rand = (torch.rand((C,), generator=gen, device="cuda")
                    > 0.3).float()
            zero = torch.zeros((C,), device="cuda")
            for mode, trim in modes:
                hold(x, rand, mode, trim)
                out = hold(x, zero, mode, trim)
                check(not bool(out.any()), "an all-zero mask gives zeros")
            hold(_shifted(torch, x, 4), rand, "trimmed_mean", 0.2)
            ties = torch.round(2.0 * x)           # integer values: ties
            hold(ties, rand, "trimmed_mean", 0.2)
            hold(ties, torch.ones((C,), device="cuda"), "median", 0.0)
    # NaN and +-inf in some columns (NaN propagates through min/max, as in
    # torch.minimum); a masked NaN becomes the sentinel and drops out
    x = torch.randn((20, 1000), generator=gen, device="cuda")
    x[3, 5], x[7, 6], x[2, 7] = math.nan, math.inf, -math.inf
    x[19, 8] = math.nan
    mask = torch.ones((20,), device="cuda")
    mask[19] = 0.0
    for mode, trim in modes:
        out = hold(x, mask, mode, trim)
        check(bool(out[5].isnan()) and not bool(out[8].isnan()),
              "NaN propagates, a masked NaN drops out")
    check(robust_combine.launches == launches + calls,
          f"{robust_combine.launches - launches} launches for {calls} calls")
    big = torch.zeros((MAX_CLIENTS + 1, 16), device="cuda")
    must_raise(ValueError, lambda: robust_combine(big), f"C={MAX_CLIENTS + 1}")
    must_raise(TypeError, lambda: robust_combine(
        torch.zeros((4, 16), dtype=torch.float64, device="cuda")),
        "a float64 input")
    check(robust_combine.launches == launches + calls,
          "a refused input launches nothing")
    print(f"robust_combine == plain network in {calls} cases "
          f"(rtol=atol=1e-6, NaN where the plain version has NaN); max "
          f"|err| {worst}; C={MAX_CLIENTS + 1} and float64 are refused")


def check_dequant_aggregate(torch):
    """Fused dequantise + weighted sum against the plain version at
    rtol=1e-5, atol=1e-6 (the sum over C is taken in another order)."""
    from repro_torch.kernels.dequant_aggregate import (
        dequant_aggregate, dequant_aggregate_ref)
    gen = torch.Generator(device="cuda").manual_seed(3)
    calls, worst = 0, 0.0
    launches = dequant_aggregate.launches
    for C in (1, 3, 20):
        for chunk in (16, 100, 256):
            for target in (chunk, 188_928, 1 << 22):
                M = max(1, round(target / chunk)) * chunk
                q = torch.randint(-127, 128, (C, M), generator=gen,
                                  device="cuda", dtype=torch.int8)
                s = 1e-4 + 1e-2 * torch.rand((C, M // chunk), generator=gen,
                                             device="cuda")
                w = torch.rand((C,), generator=gen, device="cuda")
                for qin in (q, _shifted(torch, q, 1)):
                    got = dequant_aggregate(w, s, qin, chunk)
                    want = dequant_aggregate_ref(w, s, qin, chunk)
                    torch.cuda.synchronize()
                    calls += 1
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-6)
                    worst = max(worst, float((got - want).abs().max()))
    check(dequant_aggregate.launches == launches + calls,
          f"{dequant_aggregate.launches - launches} launches for {calls} "
          f"calls")
    q16 = torch.zeros((2, 256), dtype=torch.int16, device="cuda")
    must_raise(TypeError, lambda: dequant_aggregate(
        torch.ones(2, device="cuda"), torch.ones((2, 1), device="cuda"), q16),
        "int16 codes")
    check(dequant_aggregate.launches == launches + calls,
          "a refused input launches nothing")
    print(f"dequant_aggregate == plain version in {calls} cases "
          f"(rtol=1e-5, atol=1e-6); max |err| {worst}; int16 codes are "
          f"refused")


def timing_row(torch, name, shape, fns, err, bytes_moved, operations,
               peaks):
    """One timing row: each of ``fns`` ({"kernel", "plain", "library"})
    on the device alone (``*_ms``) and eagerly (``*_eager_ms``)."""
    hbm, flops_peak = peaks
    iters = 50 if math.prod(shape) >= 1 << 24 else 200
    by_bytes, by_ops = bytes_moved / hbm, operations / flops_peak
    row = {"name": name, "shape": list(shape), "max_abs_err": err,
           "bound_ms": max(by_bytes, by_ops) * 1e3,
           "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    for key, fn in fns.items():
        row[key + "_ms"] = graph_ms(torch, fn, iters)
        row[key + "_eager_ms"] = eager_ms(torch, fn, iters)
    return row


def phase_times(torch, peaks, leaves, dim, padded_dim):
    """Each kernel beside its plain version, a library call and its bound:
    weighted_aggregate at the ten leaf shapes of path A and at M=2**22;
    robust_combine at path B's [20, D] update matrix and at M=2**22;
    dequant_aggregate at path C's [20, D_pad] int8 payload and at
    M=2**22. C=20, f32 (int8 codes for dequant_aggregate)."""
    from repro_torch.kernels.dequant_aggregate import (
        dequant_aggregate, dequant_aggregate_ref)
    from repro_torch.kernels.robust_combine import (
        combine_rows, oddeven_merge_pairs, robust_combine_network_ref,
        row_select_weights)
    from repro_torch.kernels.weighted_aggregate import (
        weighted_aggregate, weighted_aggregate_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    C, chunk = 20, 256
    rows = {k: [] for k in KERNELS}

    for M in list(leaves) + [1 << 22]:
        x = torch.randn((C, M), generator=gen, device="cuda")
        w = torch.rand((C,), generator=gen, device="cuda")
        err = float((weighted_aggregate(x, w)
                     - weighted_aggregate_ref(x, w)).abs().max())
        rows["weighted_aggregate"].append(timing_row(
            torch, "weighted_aggregate", (C, M), {
                "kernel": lambda: weighted_aggregate(x, w),
                "plain": lambda: weighted_aggregate_ref(x, w),
                "library": lambda: torch.mv(x.t(), w)},
            err, (C * M + M) * 4 + C * 4, 2 * C * M, peaks))

    pairs = len(oddeven_merge_pairs(C))
    for M in (dim, 1 << 22):
        x = torch.randn((C, M), generator=gen, device="cuda")
        mask = torch.ones((C,), device="cuda")
        w_row = row_select_weights(mask, mode="trimmed_mean",
                                   trim_fraction=TRIM)
        err = float((combine_rows(x, mask, w_row)
                     - robust_combine_network_ref(x, mask, w_row))
                    .abs().max())
        # per column: 2 min/max per compare-exchange, the mask select,
        # and the sorted-position dot (C multiplies, C-1 adds)
        rows["robust_combine"].append(timing_row(
            torch, "robust_combine", (C, M), {
                "kernel": lambda: combine_rows(x, mask, w_row),
                "plain": lambda: robust_combine_network_ref(x, mask, w_row),
                "library": lambda: torch.mv(
                    torch.sort(x, dim=0).values.t(), w_row)},
            err, (C + 1) * M * 4 + 2 * C * 4,
            (2 * pairs + 3 * C - 1) * M, peaks))

    for M in (padded_dim, 1 << 22):
        q = torch.randint(-127, 128, (C, M), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = 1e-4 + 1e-2 * torch.rand((C, M // chunk), generator=gen,
                                     device="cuda")
        w = torch.rand((C,), generator=gen, device="cuda")
        err = float((dequant_aggregate(w, s, q, chunk)
                     - dequant_aggregate_ref(w, s, q, chunk)).abs().max())
        # per code: the int8 -> f32 convert, the scale multiply and a
        # multiply-add (2)
        rows["dequant_aggregate"].append(timing_row(
            torch, "dequant_aggregate", (C, M), {
                "kernel": lambda: dequant_aggregate(w, s, q, chunk),
                "plain": lambda: dequant_aggregate_ref(w, s, q, chunk),
                "library": lambda: torch.mv(
                    (q.float().view(C, -1, chunk) * s[:, :, None])
                    .view(C, M).t(), w)},
            err, C * M + (C * M // chunk) * 4 + M * 4 + C * 4,
            4 * C * M, peaks))
    return rows


def phase_path(torch, path, argv, op_name):
    """Three full-width rounds of one path through the launcher's code
    path. Every kernel's launch count is set to 0 just before the rounds
    and read just after: ``op_name`` must have launched and no other.
    Returns (launches of op_name, round wall ms)."""
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate_ref
    from repro_torch.kernels.robust_combine import (
        robust_combine_network_ref, row_select_weights)
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate_ref
    from repro_torch.launch.train import build, parse_args
    from repro_torch.utils import tree_leaves

    t0 = time.perf_counter()
    trainer, data, cfg = build(parse_args(argv))
    state = trainer.init()
    program = trainer.program
    n_params = trainer.model.param_count(state.global_params)
    print(f"path {path}: {cfg.name} ({n_params:,} params), "
          f"{trainer.fed.num_users} users, {trainer.fed.num_testers} "
          f"testers, malicious "
          f"{trainer.attack.malicious_indices(trainer.fed.num_users)}, "
          f"aggregator {trainer.fed.aggregator}, compressor "
          f"{trainer.fed.compressor}; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_params == 188_810, f"fedtest-cnn has {n_params} params")

    # time each step of the round (host clock between two
    # synchronisations, so a step's time includes its launch overhead),
    # and keep step 7's inputs of the last round, to hold the kernel's
    # output against the plain version on exactly what it was given
    step_ms, seen = {}, {}

    def timed(step, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            step_ms[step] = (time.perf_counter() - t) * 1e3
            seen[step] = (args, out)
            return out
        return run

    backend = trainer.backend
    for step, method in (("train", "train"), ("attack", "apply_attack"),
                         ("compress", "compress_exchange"),
                         ("cross_test", "cross_test"),
                         ("updates", "updates"),
                         ("aggregate", "weighted_sum"),
                         ("aggregate", "compressed_sum")):
        setattr(backend, method, timed(step, getattr(backend, method)))
    if program.uses_combine:
        program.aggregator.combine = timed("combine",
                                           program.aggregator.combine)

    kernel_ops = ops()
    torch.cuda.synchronize()
    for op in kernel_ops.values():
        op.launches = 0
    walls = []
    for _ in range(ROUNDS):
        step_ms.clear()
        t0 = time.perf_counter()
        state, metrics = trainer.run_round(state, data)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        rest = walls[-1] - sum(step_ms.values())
        print(f"path {path} round {state.round_idx} steps ms: " + "  ".join(
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
        print(f"path {path} round {state.round_idx}: wall "
              f"{walls[-1]:.1f} ms  local_loss {values[0]:.4f}  "
              f"malicious_weight {values[1]:.5f}  global_acc {acc:.4f}  "
              f"weights [{' '.join(f'{v:.4f}' for v in w.tolist())}]")
    counts = {name: op.launches for name, op in kernel_ops.items()}
    per_round = (len(tree_leaves(state.global_params))
                 if op_name == "weighted_aggregate" else 1)
    want = {name: (per_round * ROUNDS if name == op_name else 0)
            for name in kernel_ops}
    check(counts == want, f"path {path} launches {counts}, want {want}")
    print(f"path {path} launches: {counts} ({per_round} {op_name} a round "
          f"x {ROUNDS} rounds)")

    # the last round's step-7 output against the plain version on its
    # own inputs
    if op_name == "weighted_aggregate":
        (models, weights, _), out = seen["aggregate"]
        pairs = [(got.reshape(-1), weighted_aggregate_ref(
            stack.reshape(stack.shape[0], -1), weights))
            for got, stack in zip(tree_leaves(out), tree_leaves(models))]
        tol = dict(rtol=1e-5, atol=1e-6)
    elif op_name == "robust_combine":
        (ctx, updates), out = seen["combine"]
        aggregator = program.aggregator
        mask = aggregator.gate_mask(ctx)
        w_row = row_select_weights(mask, mode=aggregator._mode,
                                   trim_fraction=aggregator.trim_fraction)
        pairs = [(out, robust_combine_network_ref(updates, mask, w_row))]
        tol = dict(rtol=1e-6, atol=1e-6)
        print(f"path {path} last gate mask: {mask.tolist()}")
    else:
        (comp, payloads, _, weights), out = seen["aggregate"]
        pairs = [(out, dequant_aggregate_ref(
            weights, payloads["scales"], payloads["q"],
            comp.chunk)[:comp.dim])]
        tol = dict(rtol=1e-5, atol=1e-6)
        one = comp.payload_bytes({k: v[0] for k, v in payloads.items()})
        print(f"path {path} wire bytes a client: int8 {one:,} against "
              f"dense f32 {4 * comp.dim:,} ({4 * comp.dim / one:.2f}x "
              f"fewer)")
    worst = 0.0
    for got, want_t in pairs:
        torch.testing.assert_close(got, want_t, **tol)
        worst = max(worst, float((got - want_t).abs().max()))
    print(f"path {path}: last round's {op_name} output == plain version on "
          f"its own inputs (max |err| {worst:.3g})")
    return counts[op_name], walls


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
    from repro_torch.core.engine import flat_update_dim
    from repro_torch.models import build_model
    from repro_torch.strategies import COMPRESSORS
    from repro_torch.utils import tree_leaves

    t_start = time.perf_counter()
    card = phase_environment(torch)
    _, peaks = card_peaks(torch.cuda.get_device_name(0))
    phase_build()
    check_weighted_aggregate(torch)
    check_robust_combine(torch)
    check_dequant_aggregate(torch)

    model = build_model(get_config("fedtest-cnn"))
    leaves = [math.prod(s) for s in tree_leaves(model.param_shapes())]
    dim = flat_update_dim(model)
    padded_dim = COMPRESSORS.build("int8", {}, dict(dim=dim)).padded_dim
    rows = phase_times(torch, peaks, leaves, dim, padded_dim)

    launches, walls = {}, {}
    for path, argv, op_name in PATHS:
        launches[op_name], walls[path] = phase_path(torch, path, argv,
                                                    op_name)

    def entry(name, path_rows, shape):
        def total(key):
            return sum(r[key] for r in path_rows)
        return {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in path_rows),
            "shape": shape,
            "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in path_rows) else "operations",
            "library_ms": total("library_ms"),
            "eager_ms": total("kernel_eager_ms"),
            "plain_eager_ms": total("plain_eager_ms"),
            "library_eager_ms": total("library_eager_ms"),
            "card": card, "shapes": rows[name]}

    for path, _, _ in PATHS:
        print(f"path {path} round wall ms: "
              f"{[round(t, 3) for t in walls[path]]} ({card})")
    print(json.dumps({"kernels": [
        # one round of path A: the 10 leaf launches at C=20
        entry("weighted_aggregate", rows["weighted_aggregate"][:len(leaves)],
              "C=20, one launch per leaf, M=" + "+".join(
                  str(m) for m in leaves)),
        # one round of path B / C: one launch on the [20, D] matrix
        entry("robust_combine", rows["robust_combine"][:1],
              f"C=20, M={dim}, trimmed mean at {TRIM}"),
        entry("dequant_aggregate", rows["dequant_aggregate"][:1],
              f"C=20, M={padded_dim} int8, chunk 256")]}))
    print(f"chip_smoke passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
