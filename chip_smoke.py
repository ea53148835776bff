#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository; it needs one CUDA card and the CUDA
toolkit (``nvcc``), and exits non-zero on the first phase that fails.

1. Environment: the card's name and power limit, the CUDA version, both
   TF32 flags (off: the port runs fp32 models in full fp32) and cuDNN's
   (deterministic, not benchmarking: a run repeats bitwise).
2. Every kernel of the port is built from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, all at once) and held against its
   plain PyTorch version on the card; bad inputs must be refused. The
   bf16 attention and SSD-scan kernels must show tensor-core
   instructions (HMMA, HGMMA) in their machine code (``cuobjdump
   -sass``). ``weighted_aggregate``'s grouped call (a tree in one launch)
   must equal its one-leaf call bitwise.
3. Times, with CUDA events: each kernel at the shapes its path gives it
   (``weighted_aggregate``: a round of path A, one grouped launch, beside
   ten ``torch.mv`` calls) and at M=2**22 (``robust_combine`` also above
   64 clients), beside its plain version, one PyTorch library call
   computing the same function, and the least time the card could take
   (its bound). Each is timed twice: on the device alone (the calls
   captured in a CUDA graph and replayed, so no host work sits between
   them) and eagerly (back-to-back calls from Python, host dispatch
   included). Where a row's inputs fit in the card's L2 four times over,
   the calls take their turns over that many copies of them, so that
   they read HBM, as the byte bound assumes. One JSON line
   ``{"kernels": [...]}`` carries them.
   The attention kernels are timed at the serve path's shapes and at one
   long shape each, beside ``F.scaled_dot_product_attention`` as the
   library yardstick (timed here only; the port never calls it).
   ``ssd_scan`` is timed at the Mamba2 serve path's shape and at one long
   shape; no single PyTorch call computes the scan, so it has no library
   row.
4. Three paths, three rounds each, of the paper's FedTest round at the
   full width of ``fedtest-cnn`` (188,810 params; 20 users, 5 testers, 3
   ``random_weights`` attackers), built by ``repro_torch.launch.train``'s
   code path on ``cuda``: A, the paper's score-weighted sum
   (``weighted_aggregate``); B, the coordinate-wise trimmed mean
   (``robust_combine``); C, the int8 compressed exchange
   (``dequant_aggregate``). Every value must be finite, the weights must
   sum to 1, the launch counts must show each path went through its
   kernel and no other, and the last step-7 output must equal the plain
   version's on the same inputs. Then path A twice more from one seed:
   its global params and score state must be bitwise equal, and its
   rounds are timed again with ``cudnn.deterministic`` off, for what the
   deterministic algorithms cost.
5. Serve: ``qwen2-0.5b`` at full width in bf16 (494,032,768 params drawn
   from a seed) through ``repro_torch.launch.serve``'s code path: a
   prompt batch of 8 x 512 tokens prefilled (``flash_attention``, one
   launch a layer), then 31 greedy decode steps (``decode_attention``
   and its merge kernel, one launch each a layer a step). Prefill ms,
   decode ms per token and tokens/s are printed beside the card; the
   launch counts must be 24 and 744 (and 744 merges) and no other
   kernel; every step's logits must be finite; the last layer's last
   prefill and decode attention calls must equal the plain versions on
   their own inputs; decode step 1's logits must match a full forward
   over the prompt and that token (teacher forcing). One prefill and one
   decode step are also captured in a CUDA graph and replayed, which
   gives the device's own time beside the host clock's.
5b. Mamba2 serve: ``mamba2-2.7b`` at full width in bf16 (2,702,579,200
   params drawn from a seed, bf16 weights with f32 ``dt_bias``,
   ``A_log``, ``D`` and norm scales) through the same code path: 8 x 512
   tokens prefilled (``ssd_scan``, one launch a layer, two chunks of
   256), then 31 greedy decode steps (the plain recurrence, no kernel).
   The launch counts must be 64 in the prefill and none in decode and no
   other kernel; every step's logits must be finite; the last layer's
   prefill scan must equal the plain version on its own inputs, y and
   state; decode step 1 must match a full forward over 513 tokens, which
   reaches the kernel's ragged last chunk (teacher forcing, on the bf16
   run and on the same weights in f32). Host-clock and
   CUDA-graph device times as for qwen2, and the device time of one
   prefill and one decode step by kernel (``torch.profiler``).

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import itertools
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
KERNELS = ("weighted_aggregate", "robust_combine", "dequant_aggregate",
           "flash_attention", "decode_attention", "ssd_scan")
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in KERNELS}
REPLACES = {
    "weighted_aggregate": "src/repro/kernels/weighted_aggregate/kernel.py:33",
    "robust_combine": "src/repro/kernels/robust_combine/kernel.py:94",
    "dequant_aggregate": "src/repro/kernels/dequant_aggregate/kernel.py:52",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:120",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:102",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:92",
}
# the serve phase: qwen2-0.5b at full width, batch 8, a 512-token prompt
# and 32 generated tokens (the first from the prefill), greedy
SERVE_ARGS = ["--device", "cuda", "--arch", "qwen2-0.5b", "--batch", "8",
              "--prompt-len", "512", "--gen", "32", "--temperature", "0",
              "--seed", "0"]
# bf16 checks: one bf16 ulp (2**-7 relative) on top of a small absolute
# slack for values near 0; f32: the softmax sums in another order
ATTN_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=8e-3, atol=1e-3)}
# teacher forcing in bf16: decode step 1's logits may differ from the full
# forward's by at most these fractions of the logits' spread (std), in the
# largest and in the mean |diff|. The two
# paths round their bf16 activations at other places (GEMMs of 8 rows
# against 8 x 513, the decode against the flash kernel) through 24
# residual layers; bf16 keeps 8 bits, about 0.4 % of a value.
SERVE_TF_TOL, SERVE_TF_MEAN_TOL = 0.15, 0.02
# the Mamba2 serve phase: mamba2-2.7b at full width, the same batch, prompt
# (two chunks of 256) and generation
SSM_SERVE_ARGS = ["--device", "cuda", "--arch", "mamba2-2.7b", "--batch",
                  "8", "--prompt-len", "512", "--gen", "32", "--temperature",
                  "0", "--seed", "0"]
# ssd_scan against its sequential plain version: f32 at rtol=atol=1e-3, the
# tolerance tests/test_kernels_ssd.py holds the chunked forms to (a
# chunk's decays are differences of a prefix sum of dt A, about 1e-4
# relative in fp32); a bf16 y at one bf16 ulp (2**-7) plus that slack
SSD_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
           "bfloat16": dict(rtol=1e-2, atol=1e-2)}
# Mamba2 teacher forcing, on the served weights upcast to f32: the two
# paths differ only in summation order (GEMMs over 8 x 512 and 8 x 513
# rows; the scan chunked against the decode recurrence for row 512), which
# 64 residual layers amplify but keep far below the logits' spread; a
# wrong ragged chunk or hand-off moves them by that whole spread. In bf16
# the two paths round at other places, which the random-init stack
# amplifies (on an H100 the served bf16 run read a largest |diff| of 0.44
# and a mean of 0.055 of the std): the bf16 bounds leave twice that
# headroom and still fail a hand-off that moves the logits by their std.
SSM_TF_TOL, SSM_TF_MEAN_TOL = 1e-2, 1e-3
SSM_TF_BF16_TOL, SSM_TF_BF16_MEAN_TOL = 1.0, 0.15

# published peaks by card (NVIDIA data sheets, dense): HBM bytes/s, fp32
# FLOP/s outside the tensor cores, bf16 FLOP/s on the tensor cores
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12),
         "H100": (3.35e12, 67e12, 989e12), "H200": (4.8e12, 67e12, 989e12)}
# the L2 cache of each of those cards (50 MB): a timing row whose inputs
# are smaller takes its calls over copies of them that fill it four times
L2_BYTES = 50 << 20


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
    """The kernel ops, by name."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.robust_combine import robust_combine
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate
    return {"weighted_aggregate": weighted_aggregate,
            "robust_combine": robust_combine,
            "dequant_aggregate": dequant_aggregate,
            "flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "ssd_scan": ssd_scan}


def reset_counts(kernel_ops) -> None:
    for op in kernel_ops.values():
        op.launches = 0
    kernel_ops["decode_attention"].merge_launches = 0


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
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; "
          f"cudnn.deterministic={torch.backends.cudnn.deterministic} "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    check(torch.backends.cudnn.deterministic
          and not torch.backends.cudnn.benchmark,
          "cuDNN deterministic, not benchmarking")
    return smi


# the bf16 kernels on the tensor cores, by their names, and how many bf16
# instances each source has: flash runs D=64 as warpgroup products
# (wgmma), D = 32 and 128 as mma.sync; decode D = 32, 64, 128 on mma.sync;
# ssd_scan's mma.sync kernel head dim P in {32, 64} x state N in {16, 128}
# x one or two C buffers. And the instances the serve paths run: qwen2's
# D=64; mamba2's P=64, N=128 (one C buffer at its batch of 8, two where
# the grid has fewer blocks than SMs)
MMA_KERNELS = {"flash_attention": (("flash_fwd_mma_kernel",
                                    "flash_fwd_wgmma_kernel"), 3),
               "decode_attention": (("decode_split_mma_kernel",), 3),
               "ssd_scan": (("ssd_scan_mma_kernel",), 8)}
SERVED = {"flash_attention": ("flash_fwd_wgmma_kernel",),
          "decode_attention": ("decode_split_mma_kernelILi64E",
                               "decode_merge_kernelI13__nv_bfloat16Li64E"),
          "ssd_scan": ("ssd_scan_mma_kernelILi64ELi128ELi1E",
                       "ssd_scan_mma_kernelILi64ELi128ELi2E")}


def sass_mma_counts(lib):
    """Tensor-core instructions (HMMA, HGMMA) in each kernel of a built
    library, by ``cuobjdump -sass`` from the toolkit that built it."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    return counts


def phase_build():
    """Build every kernel, one nvcc each, all started together; print
    nvcc's register and spill report. robust_combine has one kernel per
    C = 1..64 (and a 4-column one for C <= 32) and one staged in shared
    memory for C > 64: its report is summed up, and the C=20 kernels the
    paths use must not spill. Every instance of the attention kernels is
    printed (flash: D in {32, 64, 128} x {f32, bf16}; decode: the same,
    f32 x the query-group bucket {1, 2, 4, 8}, and a merge kernel per D
    and dtype); the bf16 D=64 ones the serve path runs must not spill.
    ssd_scan has a scalar f32 kernel per head dim P in {32, 64} x state N
    in {16, 128} and a bf16 tensor-core kernel per P x N x one or two C
    buffers; the bf16 P=64, N=128 ones the Mamba2 serve path runs must
    not spill. The machine code of the libraries with tensor-core kernels
    is read back (``cuobjdump -sass``): every bf16 instance of those
    kernels (flash: wgmma at D=64, mma.sync at 32 and 128; decode and
    ssd_scan: mma.sync) must hold HMMA or HGMMA instructions, no other
    kernel may, and their counts are printed."""
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
        spills = [(fn, int(s), int(l)) for fn, _, s, l, _ in report
                  if int(s) or int(l)]
        if name == "robust_combine":
            c20 = [fn for fn, *_ in report if "ILi20E" in fn]
            check(len(c20) == 2 and not any(fn in c20 for fn, *_ in spills),
                  f"robust_combine at C=20 spills: {spills}")
        if name in SERVED:
            served = [fn for fn, *_ in report
                      if any(key in fn for key in SERVED[name])]
            check(len(served) == len(SERVED[name])
                  and not any(fn in served for fn, *_ in spills),
                  f"{name}'s served kernels {served} spill: {spills}")
        print(f"  {name}: {len(spills)} of {len(report)} kernels spill; "
              f"max registers {max(int(r[-1]) for r in report)}")
        if name in MMA_KERNELS:
            counts = sass_mma_counts(lib)
            keys, instances = MMA_KERNELS[name]
            mma = {fn: n for fn, n in counts.items()
                   if any(key in fn for key in keys)}
            check(len(mma) == instances and all(mma.values()),
                  f"{name}: tensor-core instructions by bf16 instance "
                  f"({instances} instances) {mma}")
            for fn, n in mma.items():
                print(f"  {fn}: {n} HMMA/HGMMA instructions")
            check(not any(n for fn, n in counts.items() if fn not in mma),
                  f"{name}: only the bf16 kernels use the tensor cores")


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


def check_weighted_aggregate_grouped(torch, shapes):
    """The grouped call (``aggregate_pytree``: a tree in one launch a table
    of TABLE leaves) on path A's ten leaf shapes and on a tree of 70
    leaves (two tables; vector, ragged and, every fifth leaf, misaligned
    leaves), f32 and bf16, C=20: one launch a table, and each leaf bitwise
    equal to the one-leaf ``weighted_aggregate`` and within the array
    cases' tolerances of the plain version."""
    from repro_torch.kernels.weighted_aggregate import (
        TABLE, aggregate_pytree, weighted_aggregate, weighted_aggregate_ref)
    gen = torch.Generator(device="cuda").manual_seed(4)
    C = 20
    widths = [1, 3, 4, 8, 10, 1000, 4096, 131_072] + torch.randint(
        1, 20_000, (62,), generator=torch.Generator().manual_seed(5)).tolist()
    trees = {"path A's leaves": [(C,) + tuple(s) for s in shapes],
             "70 leaves": [(C, m) for m in widths]}
    leaves, worst = 0, {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        for label, leaf_shapes in trees.items():
            tree = {}
            for i, shape in enumerate(leaf_shapes):
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                tree[f"{i:03d}"] = _shifted(torch, x, 4) if i % 5 == 4 else x
            w = torch.rand((C,), generator=gen, device="cuda")
            before = weighted_aggregate.launches
            got = aggregate_pytree(tree, w)
            torch.cuda.synchronize()
            launches = weighted_aggregate.launches - before
            check(launches == -(-len(tree) // TABLE),
                  f"{label}: {launches} launches for {len(tree)} leaves")
            for key, stack in tree.items():
                x = stack.reshape(C, -1)
                out = got[key]
                check(out.shape == stack.shape[1:] and out.dtype == dtype,
                      f"{label} leaf {key}: {tuple(out.shape)} {out.dtype}")
                check(torch.equal(out.reshape(-1), weighted_aggregate(x, w)),
                      f"{label} leaf {key} ({dtype}, M={x.shape[1]}): the "
                      f"grouped call == the one-leaf call, bitwise")
                want = weighted_aggregate_ref(x, w)
                torch.testing.assert_close(out.reshape(-1).float(),
                                           want.float(), rtol=tol, atol=tol)
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), float(
                    (out.reshape(-1).float() - want.float()).abs().max()))
                leaves += 1
    print(f"weighted_aggregate grouped == one-leaf kernel bitwise, == plain "
          f"version (f32 rtol=atol=1e-5, bf16 rtol=atol=8e-3), in {leaves} "
          f"leaves of path A's tree and a 70-leaf tree (1 and 2 launches); "
          f"max |err| {worst}")


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
    # above 64 clients, the kernel staged in shared memory, up to
    # MAX_CLIENTS: NaN, +-inf, masked rows (a masked NaN among them), ties
    for C in (65, 100, 257, MAX_CLIENTS):
        for M in ((1, 1000, 33_000) if C < MAX_CLIENTS else (1000,)):
            x = torch.randn((C, M), generator=gen, device="cuda")
            if M >= 10:
                x[3, 5], x[C - 7, 6], x[2, 7] = math.nan, math.inf, -math.inf
                x[C - 1, 8] = math.nan
            rand = (torch.rand((C,), generator=gen, device="cuda")
                    > 0.3).float()
            rand[C - 1] = 0.0
            out = hold(x, rand, "trimmed_mean", 0.2)
            if M >= 10:
                check(not bool(out[8].isnan()) and (bool(out[5].isnan())
                                                    or not bool(rand[3])),
                      "NaN propagates, a masked NaN drops out")
            if C == MAX_CLIENTS:
                continue   # the plain network is 51,423 row ops a call
            hold(x, torch.ones((C,), device="cuda"), "median", 0.0)
            out = hold(x, torch.zeros((C,), device="cuda"), "trimmed_mean",
                       0.49)
            check(not bool(out.any()), "an all-zero mask gives zeros")
            hold(torch.round(2.0 * x), rand, "median", 0.0)
            hold(_shifted(torch, x, 4), rand, "trimmed_mean", 0.0)
    check(robust_combine.launches == launches + calls,
          f"{robust_combine.launches - launches} launches for {calls} calls")
    big = torch.zeros((MAX_CLIENTS + 1, 16), device="cuda")
    must_raise(ValueError, lambda: robust_combine(big), f"C={MAX_CLIENTS + 1}")
    must_raise(TypeError, lambda: robust_combine(
        torch.zeros((4, 16), dtype=torch.float64, device="cuda")),
        "a float64 input")
    check(robust_combine.launches == launches + calls,
          "a refused input launches nothing")
    print(f"robust_combine == plain network in {calls} cases, C = 1 .. "
          f"{MAX_CLIENTS} (rtol=atol=1e-6, NaN where the plain version has "
          f"NaN); max |err| {worst}; C={MAX_CLIENTS + 1} and float64 are "
          f"refused")


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


def _attn_inputs(torch, gen, shape_q, shape_kv, dtype):
    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(shape_q), rnd(shape_kv), rnd(shape_kv)


def _hold(torch, got, want, dtype, worst, key="out"):
    torch.testing.assert_close(got.float(), want.float(),
                               **ATTN_TOL[str(dtype).split(".")[-1]])
    k = f"{str(dtype).split('.')[-1]} {key}"
    worst[k] = max(worst.get(k, 0.0), float((got.float() - want.float())
                                             .abs().max()))


# query heads over KV heads: groups 1, 2, 7 (qwen2-0.5b's) and 8
ATTN_HEADS = ((4, 4), (4, 2), (14, 2), (8, 1))


def check_flash_attention(torch):
    """The flash kernel against its plain version in f32 and bf16: groups
    1, 2, 7, 8; head_dim 32, 64, 128; causal and not; window None, 8,
    100 and 200 (across key-tile edges); S = T = 64 (whole tiles), S = T
    = 77 (ragged), S=40 inside T=131 at q_offset 91 (ragged, S < T), S =
    T = 300 (five key tiles, ragged: the bf16 kernel's ring wraps) and
    S=1 inside T=1000 at q_offset 999 (one query over 16 key tiles)."""
    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(4)
    calls, worst = 0, {}
    launches = flash_attention.launches
    for dtype in (torch.float32, torch.bfloat16):
        for Hq, Hkv in ATTN_HEADS:
            for D in (32, 64, 128):
                for S, T, off in ((64, 64, 0), (77, 77, 0), (40, 131, 91),
                                  (300, 300, 0), (1, 1000, 999)):
                    q, k, v = _attn_inputs(torch, gen, (2, S, Hq, D),
                                           (2, T, Hkv, D), dtype)
                    for causal in (True, False):
                        for window in (None, 8, 100, 200):
                            kw = dict(causal=causal, sliding_window=window,
                                      q_offset=off)
                            got = flash_attention(q, k, v, **kw)
                            want = attention_ref(q, k, v, **kw)
                            torch.cuda.synchronize()
                            calls += 1
                            check(got.dtype == dtype
                                  and got.shape == q.shape,
                                  f"output {got.dtype} {tuple(got.shape)}")
                            _hold(torch, got, want, dtype, worst)
    check(flash_attention.launches == launches + calls,
          f"{flash_attention.launches - launches} launches for {calls} "
          f"calls")
    q, k, v = _attn_inputs(torch, gen, (2, 8, 4, 64), (2, 8, 2, 64),
                           torch.bfloat16)
    must_raise(ValueError, lambda: flash_attention(
        q.transpose(1, 2).contiguous().transpose(1, 2), k, v),
        "a non-contiguous q")
    must_raise(ValueError, lambda: flash_attention(
        q[..., :48].contiguous(), k[..., :48].contiguous(),
        v[..., :48].contiguous()), "head_dim 48")
    must_raise(TypeError, lambda: flash_attention(q.half(), k.half(),
                                                  v.half()), "float16")
    must_raise(ValueError, lambda: flash_attention(_shifted(torch, q, 2), k,
                                                   v), "a misaligned q")
    check(flash_attention.launches == launches + calls,
          "a refused input launches nothing")
    print(f"flash_attention == plain version in {calls} cases (|err| <= "
          f"{ATTN_TOL['float32']['atol']} + {ATTN_TOL['float32']['rtol']}"
          f"|plain| in f32, <= {ATTN_TOL['bfloat16']['atol']} + "
          f"{ATTN_TOL['bfloat16']['rtol']}|plain| in bf16); max |err| "
          f"{worst}; a non-contiguous q, head_dim 48, float16 and a bf16 q "
          f"off a 16-byte boundary are refused without a launch")


def check_decode_attention(torch):
    """The split-K decode kernel and its merge against the plain version,
    out and lse, in f32 and bf16: groups 1, 2, 7, 8; head_dim 32, 64,
    128; window None, 8, 100 on caches of 64 keys (one split), 545 and
    1000 with lengths 1, 2 (shorter than a tile), 63 and the whole cache;
    window None and 300 on a cache of 4099 keys with lengths 1, 64, 2049
    and 4099 (splits of several tiles: the bf16 kernel's ring wraps, and
    the last tile is ragged)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(5)
    calls, worst = 0, {}
    launches = decode_attention.launches
    merges = decode_attention.merge_launches
    caches = [(T, [1, 2, 63, T], (None, 8, 100)) for T in (64, 545, 1000)]
    caches.append((4099, [1, 64, 2049, 4099], (None, 300)))
    for dtype in (torch.float32, torch.bfloat16):
        for Hq, Hkv in ATTN_HEADS:
            for D in (32, 64, 128):
                for T, lens, windows in caches:
                    q, k, v = _attn_inputs(torch, gen, (4, Hq, D),
                                           (4, T, Hkv, D), dtype)
                    lengths = torch.tensor(lens, dtype=torch.int32,
                                           device="cuda")
                    for window in windows:
                        out, lse = decode_attention(q, k, v, lengths,
                                                    window=window)
                        want_out, want_lse = decode_attention_ref(
                            q, k, v, lengths, window=window)
                        torch.cuda.synchronize()
                        calls += 1
                        check(out.dtype == dtype and out.shape == q.shape
                              and lse.dtype == torch.float32
                              and lse.shape == (4, Hq),
                              f"outputs {out.dtype} {tuple(out.shape)}, "
                              f"{lse.dtype} {tuple(lse.shape)}")
                        _hold(torch, out, want_out, dtype, worst)
                        _hold(torch, lse, want_lse, torch.float32, worst,
                              key=f"lse ({str(dtype).split('.')[-1]} in)")
    check(decode_attention.launches == launches + calls
          and decode_attention.merge_launches == merges + calls,
          f"{decode_attention.launches - launches} launches and "
          f"{decode_attention.merge_launches - merges} merges for {calls} "
          f"calls")
    q, k, v = _attn_inputs(torch, gen, (2, 4, 64), (2, 64, 2, 64),
                           torch.bfloat16)
    lengths = torch.tensor([64, 5], dtype=torch.int32, device="cuda")
    must_raise(ValueError, lambda: decode_attention(
        q, k[:, ::2], v[:, ::2], lengths), "a non-contiguous cache")
    must_raise(TypeError, lambda: decode_attention(q, k, v, lengths.long()),
               "int64 lengths")
    q16, k16, v16 = _attn_inputs(torch, gen, (2, 16, 64), (2, 64, 1, 64),
                                 torch.bfloat16)
    must_raise(ValueError, lambda: decode_attention(q16, k16, v16, lengths),
               "16 query heads a KV head")
    must_raise(ValueError, lambda: decode_attention(_shifted(torch, q, 2), k,
                                                    v, lengths),
               "a misaligned bf16 q")
    check(decode_attention.launches == launches + calls,
          "a refused input launches nothing")
    print(f"decode_attention == plain version in {calls} cases, out and "
          f"lse (|err| <= {ATTN_TOL['float32']['atol']} + "
          f"{ATTN_TOL['float32']['rtol']}|plain| in f32 and for lse, <= "
          f"{ATTN_TOL['bfloat16']['atol']} + {ATTN_TOL['bfloat16']['rtol']}"
          f"|plain| for a bf16 out); max |err| {worst}; a non-contiguous "
          f"cache, int64 lengths, a group of 16 and a misaligned bf16 q are "
          f"refused without a launch")


def _ssd_inputs(torch, gen, Bt, S, H, P, G, N, dtype, *, mamba_init,
                strided):
    """x, dt, A, B, C, D on the card. ``mamba_init``: A = -linspace(1, 16,
    H), as the model draws it (a chunk's cum of dt A then reaches the
    thousands), else -exp(N(0, 1)); dt = softplus(N(0, 1)). ``strided``:
    x, B and C are slices of one [Bt, S, H P + 2 G N] tensor, the layout
    in which the model hands them over."""
    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if strided:
        u = rnd((Bt, S, H * P + 2 * G * N)).to(dtype)
        x = u[..., :H * P].view(Bt, S, H, P)
        B = u[..., H * P:H * P + G * N].view(Bt, S, G, N)
        C = u[..., H * P + G * N:].view(Bt, S, G, N)
    else:
        x, B, C = (rnd(shape).to(dtype) for shape in (
            (Bt, S, H, P), (Bt, S, G, N), (Bt, S, G, N)))
    dt = torch.nn.functional.softplus(rnd((Bt, S, H)))
    A = (-torch.linspace(1.0, 16.0, H, device="cuda") if mamba_init
         else -torch.exp(rnd((H,))))
    return x, dt, A, B, C, rnd((H,))


def _hold_ssd(torch, got, want, dtype, worst):
    (y, st), (yr, sr) = got, want
    name = str(dtype).split(".")[-1]
    torch.testing.assert_close(y.float(), yr.float(), **SSD_TOL[name])
    torch.testing.assert_close(st, sr, **SSD_TOL["float32"])
    for key, a, b in ((f"{name} y", y, yr), (f"state ({name} in)", st, sr)):
        worst[key] = max(worst.get(key, 0.0),
                         float((a.float() - b.float()).abs().max()))


def check_ssd_scan(torch):
    """The SSD scan kernel against its sequential plain version, y and the
    final state, in f32 and bf16: chunk 32, 64, 256; S ragged (two chunks
    and 13 rows) and S shorter than a chunk; head dim P 32, 64; state N
    16, 128; groups G 1, 2 with H/G 1, 4, 80 (A as the model draws it at
    H/G = 80). Every other case reads x, B, C as slices of one wider
    tensor, as the model passes them. Then, at chunk 256 and the served
    widths: Bt=1, S=8192 in both dtypes, Bt=1 at P = 32 and 64 (80
    blocks, fewer than the SMs: the bf16 route's two-C-buffer instance),
    S = 3 x 256 + 1."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(7)
    calls, worst = 0, {}
    launches = ssd_scan.launches
    for dtype in (torch.float32, torch.bfloat16):
        for chunk in (32, 64, 256):
            for S in (2 * chunk + 13, chunk // 2 + 3):
                for P, N in ((32, 16), (64, 128), (32, 128), (64, 16)):
                    for G, rep in ((1, 1), (2, 1), (1, 4), (2, 4), (1, 80),
                                   (2, 80)):
                        H = G * rep
                        args = _ssd_inputs(torch, gen, 2, S, H, P, G, N,
                                           dtype, mamba_init=rep == 80,
                                           strided=calls % 2 == 0)
                        y, st = ssd_scan(*args, chunk=chunk)
                        want = ssd_ref(*args)
                        torch.cuda.synchronize()
                        calls += 1
                        check(y.dtype == dtype and y.shape == (2, S, H, P)
                              and st.dtype == torch.float32
                              and st.shape == (2, H, P, N),
                              f"outputs {y.dtype} {tuple(y.shape)}, "
                              f"{st.dtype} {tuple(st.shape)}")
                        _hold_ssd(torch, (y, st), want, dtype, worst)
    # chunk 256 with A as the model draws it: the long shape (Bt=1,
    # S=8192) in both dtypes; Bt=1 at both head dims P = 32 and 64, on the
    # two-C-buffer instance that Bt * H <= the SM count selects; three
    # chunks and one row (S = 3 x 256 + 1)
    more = [(dtype, 1, 8192, 80, 64) for dtype in (torch.float32,
                                                   torch.bfloat16)]
    more += [(torch.bfloat16, 1, 2 * 256 + 13, 80, P) for P in (32, 64)]
    more += [(dtype, 2, 3 * 256 + 1, 80, 64) for dtype in (torch.float32,
                                                           torch.bfloat16)]
    for dtype, Bt, S, H, P in more:
        args = _ssd_inputs(torch, gen, Bt, S, H, P, 1, 128, dtype,
                           mamba_init=True, strided=True)
        y, st = ssd_scan(*args, chunk=256)
        want = ssd_ref(*args)
        torch.cuda.synchronize()
        calls += 1
        check(y.shape == (Bt, S, H, P) and st.shape == (Bt, H, P, 128),
              f"outputs {tuple(y.shape)}, {tuple(st.shape)}")
        _hold_ssd(torch, (y, st), want, dtype, worst)
    check(ssd_scan.launches == launches + calls,
          f"{ssd_scan.launches - launches} launches for {calls} calls")
    x, dt, A, B, C, D = _ssd_inputs(torch, gen, 1, 40, 4, 64, 2, 16,
                                    torch.bfloat16, mamba_init=False,
                                    strided=False)
    must_raise(ValueError, lambda: ssd_scan(
        x[..., :48], dt, A, B, C, D), "head dim 48")
    must_raise(ValueError, lambda: ssd_scan(
        x, dt, A, B[..., :8], C[..., :8], D), "state 8")
    must_raise(ValueError, lambda: ssd_scan(
        x, dt, A, B, C, D, chunk=4096), "chunk 4096")
    must_raise(ValueError, lambda: ssd_scan(
        x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C, D),
        "an x strided in its last dimension")
    must_raise(ValueError, lambda: ssd_scan(
        x, dt, A, B[:, :, :1].expand(1, 40, 3, 16),
        C[:, :, :1].expand(1, 40, 3, 16), D), "H=4 over G=3")
    must_raise(TypeError, lambda: ssd_scan(x.half(), dt, A, B.half(),
                                           C.half(), D), "float16")
    must_raise(ValueError, lambda: ssd_scan(
        _shifted(torch, x, 2), dt, A, B, C, D), "a bf16 x off 16 bytes")
    check(ssd_scan.launches == launches + calls,
          "a refused input launches nothing")
    print(f"ssd_scan == plain version in {calls} cases, y and state (|err| "
          f"<= {SSD_TOL['float32']['atol']} + {SSD_TOL['float32']['rtol']}"
          f"|plain| in f32 and for the state, <= "
          f"{SSD_TOL['bfloat16']['atol']} + {SSD_TOL['bfloat16']['rtol']}"
          f"|plain| for a bf16 y); max |err| {worst}; head dim 48, state 8, "
          f"chunk 4096, a strided last dimension, H % G != 0, float16 and "
          f"a bf16 x off 16 bytes are refused without a launch")


def timing_row(torch, name, shape, fns, make, err, bytes_moved, operations,
               peaks, iters=None):
    """One timing row: each of ``fns`` ({"kernel", "plain", "library"}),
    a function of the inputs ``make()`` returns, on the device alone
    (``*_ms``, CUDA-graph replay) and eagerly (``*_eager_ms``), over
    ``iters`` calls (by default 200, or 50 from 2**24 elements on; a dict
    gives each of ``fns`` its own). ``make()`` is called as often as it
    takes for the copies to hold ``bytes_moved`` four times the L2, and
    the calls take the copies in turn: a graph that replays one small
    input would read it from L2, faster than the HBM rate of the bound."""
    hbm, flops_peak = peaks
    if iters is None:
        iters = 50 if math.prod(shape) >= 1 << 24 else 200
    copies = [make() for _ in range(-(-4 * L2_BYTES // bytes_moved))]
    by_bytes, by_ops = bytes_moved / hbm, operations / flops_peak
    row = {"name": name, "shape": list(shape), "max_abs_err": err,
           "bound_ms": max(by_bytes, by_ops) * 1e3,
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "input_copies": len(copies)}
    for key, fn in fns.items():
        n = iters[key] if isinstance(iters, dict) else iters
        turn = itertools.count()

        def call(fn=fn, turn=turn):
            return fn(*copies[next(turn) % len(copies)])
        row[key + "_ms"] = graph_ms(torch, call, n)
        row[key + "_eager_ms"] = eager_ms(torch, call, n)
    return row


def phase_times(torch, peaks, shapes, dim, padded_dim):
    """Each kernel beside its plain version, a library call and its bound:
    weighted_aggregate on one round of path A (its ten leaves, shapes
    ``shapes``, in one grouped launch, beside ten plain reductions and ten
    ``torch.mv`` calls) and at M=2**22; robust_combine at path B's [20, D]
    update matrix and at M=2**22, then above 64 clients at [100, D] and
    [1024, 2**16] beside ``torch.sort`` + ``torch.mv`` only (the plain
    network is thousands of row ops a call there); dequant_aggregate at
    path C's [20, D_pad] int8 payload and at M=2**22. C=20, f32 (int8
    codes for dequant_aggregate)."""
    from repro_torch.kernels.dequant_aggregate import (
        dequant_aggregate, dequant_aggregate_ref)
    from repro_torch.kernels.robust_combine import (
        combine_rows, oddeven_merge_pairs, robust_combine_network_ref,
        row_select_weights)
    from repro_torch.kernels.weighted_aggregate import (
        aggregate_pytree, weighted_aggregate, weighted_aggregate_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    C, chunk = 20, 256
    rows = {k: [] for k in KERNELS}

    w = torch.rand((C,), generator=gen, device="cuda")

    def round_tree():    # a round's stacked tree and its leaves as [C, m]
        stacked = {f"{i:02d}": torch.randn((C,) + tuple(s), generator=gen,
                                           device="cuda")
                   for i, s in enumerate(shapes)}
        return stacked, [stacked[k].reshape(C, -1) for k in sorted(stacked)]
    stacked, flats = round_tree()
    got = aggregate_pytree(stacked, w)
    err = max(float((got[k].reshape(-1) - weighted_aggregate_ref(x, w))
                    .abs().max()) for k, x in zip(sorted(stacked), flats))
    M = sum(x.shape[1] for x in flats)
    rows["weighted_aggregate"].append(timing_row(
        torch, "weighted_aggregate", (C, M), {
            "kernel": lambda tree, flats: aggregate_pytree(tree, w),
            "plain": lambda tree, flats: [weighted_aggregate_ref(x, w)
                                          for x in flats],
            "library": lambda tree, flats: [torch.mv(x.t(), w)
                                            for x in flats]},
        round_tree, err, (C + 1) * M * 4 + len(flats) * C * 4, 2 * C * M,
        peaks))
    M = 1 << 22

    def matrix(rows_=C, cols=M):
        return (torch.randn((rows_, cols), generator=gen, device="cuda"),)
    x, = matrix()
    err = float((weighted_aggregate(x, w)
                 - weighted_aggregate_ref(x, w)).abs().max())
    rows["weighted_aggregate"].append(timing_row(
        torch, "weighted_aggregate", (C, M), {
            "kernel": lambda x: weighted_aggregate(x, w),
            "plain": lambda x: weighted_aggregate_ref(x, w),
            "library": lambda x: torch.mv(x.t(), w)},
        matrix, err, (C * M + M) * 4 + C * 4, 2 * C * M, peaks))

    for Cr, M, plain in ((C, dim, True), (C, 1 << 22, True), (100, dim, False),
                         (1024, 1 << 16, False)):
        x, = matrix(Cr, M)
        mask = torch.ones((Cr,), device="cuda")
        w_row = row_select_weights(mask, mode="trimmed_mean",
                                   trim_fraction=TRIM)
        got = combine_rows(x, mask, w_row)
        want = (robust_combine_network_ref(x, mask, w_row) if plain else
                torch.mv(torch.sort(x, dim=0).values.t(), w_row))
        err = float((got - want).abs().max())
        fns = {"kernel": lambda x: combine_rows(x, mask, w_row),
               "library": lambda x: torch.mv(
                   torch.sort(x, dim=0).values.t(), w_row)}
        if plain:
            fns["plain"] = lambda x: robust_combine_network_ref(x, mask,
                                                                w_row)
        # per column: 2 min/max per compare-exchange, the mask select,
        # and the sorted-position dot (C multiplies, C-1 adds)
        rows["robust_combine"].append(timing_row(
            torch, "robust_combine", (Cr, M), fns,
            lambda: matrix(Cr, M), err, (Cr + 1) * M * 4 + 2 * Cr * 4,
            (2 * len(oddeven_merge_pairs(Cr)) + 3 * Cr - 1) * M, peaks,
            iters=None if Cr <= 100 else 3))

    for M in (padded_dim, 1 << 22):
        def codes(M=M):
            q = torch.randint(-127, 128, (C, M), generator=gen,
                              device="cuda", dtype=torch.int8)
            s = 1e-4 + 1e-2 * torch.rand((C, M // chunk), generator=gen,
                                         device="cuda")
            return q, s
        q, s = codes()
        w = torch.rand((C,), generator=gen, device="cuda")
        err = float((dequant_aggregate(w, s, q, chunk)
                     - dequant_aggregate_ref(w, s, q, chunk)).abs().max())
        # per code: the int8 -> f32 convert, the scale multiply and a
        # multiply-add (2)
        rows["dequant_aggregate"].append(timing_row(
            torch, "dequant_aggregate", (C, M), {
                "kernel": lambda q, s: dequant_aggregate(w, s, q, chunk),
                "plain": lambda q, s: dequant_aggregate_ref(w, s, q, chunk),
                "library": lambda q, s: torch.mv(
                    (q.float().view(C, -1, chunk) * s[:, :, None])
                    .view(C, q.shape[1]).t(), w)},
            codes, err, C * M + (C * M // chunk) * 4 + M * 4 + C * 4,
            4 * C * M, peaks))
    return rows


def phase_attention_times(torch, peaks):
    """flash_attention and decode_attention beside their plain versions,
    ``F.scaled_dot_product_attention`` (GQA through ``enable_gqa``; for
    decode a boolean mask built from ``lengths``) and the bound, in bf16:
    at the serve path's shapes (flash B=8, S=T=512, Hq=14, Hkv=2, D=64,
    causal; decode B=8, a 545-row cache, lengths 513..543) and at one long
    shape each (flash B=1, S=T=4096; decode B=32, T=32,768; 20 calls a
    CUDA graph, so that the graph's own launch weighs little beside calls
    of about 0.2 ms). Bounds: each input read once and the output written
    once over HBM's rate, against the two products' 4 * D flops a (query
    head, attended key) pair at the tensor cores' bf16 rate."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_ref)
    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention)
    hbm, bf16_peak = peaks[0], peaks[2]
    gen = torch.Generator(device="cuda").manual_seed(6)
    Hq, Hkv, D = 14, 2, 64
    rows = {"flash_attention": [], "decode_attention": []}
    for B, S, iters in ((8, 512, None), (1, 4096, 20)):
        def make(B=B, S=S):
            return _attn_inputs(torch, gen, (B, S, Hq, D), (B, S, Hkv, D),
                                torch.bfloat16)
        q, k, v = make()
        err = float((flash_attention(q, k, v).float()
                     - attention_ref(q, k, v).float()).abs().max())
        pairs = S * (S + 1) // 2                    # causal, q_offset 0
        rows["flash_attention"].append(timing_row(
            torch, "flash_attention", (B, S, S, Hq, Hkv, D), {
                "kernel": flash_attention,
                "plain": attention_ref,
                "library": lambda q, k, v: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True)},
            make, err, 2 * (2 * q.numel() + k.numel() + v.numel()),
            4 * D * Hq * B * pairs, (hbm, bf16_peak), iters=iters))
    for B, T, lengths, iters in (
            (8, 545, 513 + torch.arange(8) * 30 // 7, None),
            (32, 32768, 32768 - torch.arange(32) * 64, 20)):
        def make(B=B, T=T):
            return _attn_inputs(torch, gen, (B, Hq, D), (B, T, Hkv, D),
                                torch.bfloat16)
        q, k, v = make()
        lengths = lengths.to(device="cuda", dtype=torch.int32)
        got, _ = decode_attention(q, k, v, lengths)
        err = float((got.float() - decode_attention_ref(q, k, v, lengths)[0]
                     .float()).abs().max())
        keys = int(lengths.clamp(max=T).sum())
        mask = (torch.arange(T, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        rows["decode_attention"].append(timing_row(
            torch, "decode_attention", (B, T, Hq, Hkv, D), {
                "kernel": lambda q, k, v: decode_attention(q, k, v, lengths),
                "plain": lambda q, k, v: decode_attention_ref(q, k, v,
                                                              lengths),
                "library": lambda q, k, v: F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)},
            make, err,
            # the valid keys' k and v rows, q, out (bf16), lse (f32) and
            # the lengths
            2 * 2 * keys * Hkv * D + 2 * 2 * q.numel() + 4 * B * Hq + 4 * B,
            4 * D * Hq * keys, (hbm, bf16_peak), iters=iters))
    for name, found in rows.items():
        for r in found:
            print(f"{name} {r['shape']}: device {r['kernel_ms']:.5f} ms "
                  f"(eager {r['kernel_eager_ms']:.5f}), plain "
                  f"{r['plain_ms']:.5f}, sdpa {r['library_ms']:.5f}, bound "
                  f"{r['bound_ms']:.5f} ({r['bound_by']}), max |err| "
                  f"{r['max_abs_err']:.3g}")
    return rows


def ssd_work(Bt, S, H, P, G, N, chunk, itemsize):
    """(bytes, operations) of one scan: x and y, B, C (``itemsize`` bytes
    each), dt and the final state (f32) moved once; per (b, h, chunk) of q
    rows, the four products q (q + 1) (N + P) + 4 q P N: C B^T and its
    product with x over the q (q + 1) / 2 pairs i >= j that the causal
    decay keeps (the mask zeroes the rest), C h0^T and the state update."""
    bytes_moved = (itemsize * (2 * Bt * S * H * P + 2 * Bt * S * G * N)
                   + 4 * (Bt * S * H + Bt * H * P * N + 2 * H))
    rows = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    operations = Bt * H * sum(q * (q + 1) * (N + P) + 4 * q * P * N
                              for q in rows)
    return bytes_moved, operations


def phase_ssd_times(torch, peaks):
    """ssd_scan beside its plain version and the bound, bf16, at the
    Mamba2 serve path's shape (Bt=8, S=512, H=80, P=64, G=1, N=128, chunk
    256: one call, one layer of the prefill) and a long one (Bt=1,
    S=8192). x, B, C are slices of one tensor as the model passes them; A
    as the model draws it. Bound: ``ssd_work`` over HBM's rate and the
    tensor cores' bf16 rate. No single PyTorch call computes the scan, so
    there is no library row. The two rows stand for the two sides of the
    kernel's choice of C buffers (``c_buffers`` in ``csrc/ssd_scan.cu``):
    the serve shape's 640 blocks run the one-buffer instance, Bt=1's 80
    the two-buffer one."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    hbm, bf16_peak = peaks[0], peaks[2]
    gen = torch.Generator(device="cuda").manual_seed(8)
    H, P, G, N, chunk = 80, 64, 1, 128, 256
    rows = []
    for Bt, S, iters in ((8, 512, {"kernel": 20, "plain": 2}),
                         (1, 8192, {"kernel": 5, "plain": 1})):
        def make(Bt=Bt, S=S):
            return _ssd_inputs(torch, gen, Bt, S, H, P, G, N, torch.bfloat16,
                               mamba_init=True, strided=True)
        args = make()
        y, st = ssd_scan(*args, chunk=chunk)
        yr, sr = ssd_ref(*args)
        err = max(float((y.float() - yr.float()).abs().max()),
                  float((st - sr).abs().max()))
        rows.append(timing_row(
            torch, "ssd_scan", (Bt, S, H, P, G, N), {
                "kernel": lambda *a: ssd_scan(*a, chunk=chunk),
                "plain": ssd_ref},
            make, err, *ssd_work(Bt, S, H, P, G, N, chunk, 2), (hbm, bf16_peak),
            iters=iters))
    for r in rows:
        print(f"ssd_scan {r['shape']}: device {r['kernel_ms']:.5f} ms "
              f"(eager {r['kernel_eager_ms']:.5f}), plain {r['plain_ms']:.3f}"
              f" (eager {r['plain_eager_ms']:.3f}), no library call, bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}), max |err| "
              f"{r['max_abs_err']:.3g}")
    return {"ssd_scan": rows}


def phase_path(torch, path, argv, op_name):
    """Three full-width rounds of one path through the launcher's code
    path. Every kernel's launch count is set to 0 just before the rounds
    and read just after: ``op_name`` must have launched and no other.
    Returns (launches of op_name, round wall ms)."""
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate_ref
    from repro_torch.kernels.robust_combine import (
        robust_combine_network_ref, row_select_weights)
    from repro_torch.kernels.weighted_aggregate import (
        plan_launches, weighted_aggregate_ref)
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
    reset_counts(kernel_ops)
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
    # path A: the grouped kernel's launches for the tree (one a table of
    # TABLE leaves: 1 for fedtest-cnn's 10); B and C: one a round
    leaf_sizes = [p.numel() for p in tree_leaves(state.global_params)]
    per_round = (len(plan_launches(leaf_sizes, [True] * len(leaf_sizes), 4))
                 if op_name == "weighted_aggregate" else 1)
    want = {name: (per_round * ROUNDS if name == op_name else 0)
            for name in kernel_ops}
    check(counts == want
          and kernel_ops["decode_attention"].merge_launches == 0,
          f"path {path} launches {counts}, want {want}")
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


REPRO_ROUNDS = 5


def phase_reproducible(torch, card):
    """Path A from one seed, built anew and run REPRO_ROUNDS rounds, twice
    with the device flags ``resolve_device`` sets: the global params and
    the score state must come out bitwise equal (``torch.equal`` on every
    leaf), as the reference's resume rule asks of a run. Where they differ,
    one more round runs under ``torch.use_deterministic_algorithms(True)``,
    in a process of its own, which names an op with no deterministic
    form, and the phase fails.
    Between and after those runs, the same rounds with
    ``cudnn.deterministic`` switched off for that run only: the steady
    rounds (all but the first) of both settings give the deterministic
    algorithms' cost. Returns the numbers printed."""
    from repro_torch.launch.train import build, parse_args
    from repro_torch.utils import tree_leaves

    def run(deterministic):
        trainer, data, _ = build(parse_args(MAIN_PATH_ARGS))
        torch.backends.cudnn.deterministic = deterministic
        try:
            state, walls = trainer.init(), []
            for _ in range(REPRO_ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = trainer.run_round(state, data)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        finally:
            torch.backends.cudnn.deterministic = True
        return state, walls

    def differing(one, two):
        pairs = ([(f"param {i}", a, b) for i, (a, b) in enumerate(zip(
            tree_leaves(one.global_params),
            tree_leaves(two.global_params)))]
            + [(f"scores.{name}", getattr(one.scores, name),
                getattr(two.scores, name))
               for name in one.scores._fields])
        return len(pairs), [name for name, a, b in pairs
                            if not torch.equal(a, b)]

    first, det_a = run(True)
    loose_a, nondet_a = run(False)
    second, det_b = run(True)
    loose_b, nondet_b = run(False)
    n_tensors, differ = differing(first, second)
    if differ:
        # in a process of its own: cuBLAS runs deterministically under
        # torch.use_deterministic_algorithms only with this variable set
        # before its first call, and the timed phases run as the CLI does
        run_alone = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             "chip_smoke.name_nondeterministic_op()"], cwd=ROOT,
            env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
            capture_output=True, text=True, timeout=600)
        named = run_alone.stdout.strip() or run_alone.stderr.strip()[-500:]
        print(f"path A twice from one seed: {differ} differ; under "
              f"torch.use_deterministic_algorithms: {named}")
    check(not differ, f"path A twice from one seed is bitwise equal "
          f"({n_tensors} tensors; differ: {differ})")
    _, loose_differ = differing(loose_a, loose_b)
    det = det_a[1:] + det_b[1:]
    nondet = nondet_a[1:] + nondet_b[1:]
    numbers = {"rounds": REPRO_ROUNDS, "deterministic_ms": det_a + det_b,
               "nondeterministic_runs_differ_in": loose_differ,
               "nondeterministic_ms": nondet_a + nondet_b,
               "steady_deterministic_mean_ms": sum(det) / len(det),
               "steady_nondeterministic_mean_ms": sum(nondet) / len(nondet),
               "card": card}
    print(f"path A twice from one seed, {REPRO_ROUNDS} rounds: global "
          f"params and score state bitwise equal ({n_tensors} tensors); "
          f"with cudnn.deterministic off the two runs differ in "
          f"{len(loose_differ)} of them")
    print(f"path A round wall ms, cudnn.deterministic=True: "
          f"{[round(t, 3) for t in det_a + det_b]}; False: "
          f"{[round(t, 3) for t in nondet_a + nondet_b]}; steady means "
          f"{numbers['steady_deterministic_mean_ms']:.3f} against "
          f"{numbers['steady_nondeterministic_mean_ms']:.3f} ({card})")
    return numbers


def name_nondeterministic_op() -> None:
    """One round of path A under ``torch.use_deterministic_algorithms``,
    which refuses an op with no deterministic form: prints the refusal's
    first line, or that none came."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.train import build, parse_args
    trainer, data, _ = build(parse_args(MAIN_PATH_ARGS))
    torch.use_deterministic_algorithms(True)
    try:
        trainer.run_round(trainer.init(), data)
        torch.cuda.synchronize()
        print("no op refused")
    except RuntimeError as err:
        print(str(err).splitlines()[0])


def phase_serve(torch, card):
    """qwen2-0.5b at full width in bf16 through the serve launcher's code
    path (``repro_torch.launch.serve``: ``build`` then ``serve``): one
    warm-up pass, then the measured pass with every kernel count set to 0
    just before it and read just after. Returns (launch counts, the
    numbers printed)."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.launch import serve as serve_mod

    t0 = time.perf_counter()
    args = serve_mod.parse_args(SERVE_ARGS)
    model, params, tokens, gen = serve_mod.build(args)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = model.param_count(params)
    check(n_params == 494_032_768, f"qwen2-0.5b has {n_params} params")
    check(params["embed"].dtype == torch.bfloat16
          and params["final_norm"]["scale"].dtype == torch.float32,
          "bf16 weights, f32 norm scales")
    B, S = tokens.shape
    print(f"serve: {cfg.name} ({n_params:,} params, {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}), batch {B}, prompt {S}, gen "
          f"{args.gen}; set-up {time.perf_counter() - t0:.2f} s")

    # the attention calls, recorded where the model makes them, so that
    # the last ones can be held against the plain versions afterwards
    seen = {}

    def recorder(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            seen[name] = (a, kw, out)
            return out
        return run

    finite, step1 = [], {}

    def on_step(i, logits):
        finite.append(torch.isfinite(logits).all())
        if i == 1:
            step1["logits"] = logits[:, 0].float().clone()

    kernel_ops = ops()
    originals = attn_mod.flash_attention, attn_mod.decode_attention
    attn_mod.flash_attention = recorder("flash", originals[0])
    attn_mod.decode_attention = recorder("decode", originals[1])
    try:
        warm = serve_mod.serve(model, params, tokens, args.gen,
                               args.temperature, gen)
        del warm
        finite.clear()
        torch.cuda.synchronize()
        reset_counts(kernel_ops)
        res = serve_mod.serve(model, params, tokens, args.gen,
                              args.temperature, gen, on_step=on_step)
        counts = {name: op.launches for name, op in kernel_ops.items()}
        counts["decode_attention merge"] = (
            kernel_ops["decode_attention"].merge_launches)
    finally:
        attn_mod.flash_attention, attn_mod.decode_attention = originals
    steps = args.gen - 1
    want = {name: 0 for name in counts}
    want.update({"flash_attention": cfg.num_layers,
                 "decode_attention": steps * cfg.num_layers,
                 "decode_attention merge": steps * cfg.num_layers})
    check(counts == want, f"serve launches {counts}, want {want}")
    print(f"serve launches: {counts} (flash: 1 prefill x {cfg.num_layers} "
          f"layers; decode: {steps} steps x {cfg.num_layers} layers)")
    check(len(finite) == args.gen and all(bool(f) for f in finite),
          "finite logits at the prefill and every decode step")
    gen_tokens = res["tokens"]
    check(gen_tokens.shape == (B, args.gen)
          and bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size))
                   .all()), f"tokens {tuple(gen_tokens.shape)} in range")

    # the last layer's last prefill and decode attention calls against the
    # plain versions on the same inputs
    (q, k, v), kw, got = seen["flash"]
    want_out = attention_ref(q, k, v, **kw)
    worst = {"flash": float((got.float() - want_out.float()).abs().max())}
    torch.testing.assert_close(got.float(), want_out.float(),
                               **ATTN_TOL["bfloat16"])
    (q, kc, vc, lengths), kw, (out, lse) = seen["decode"]
    want_o, want_l = decode_attention_ref(q, kc, vc, lengths, **kw)
    torch.testing.assert_close(out.float(), want_o.float(),
                               **ATTN_TOL["bfloat16"])
    torch.testing.assert_close(lse, want_l, **ATTN_TOL["float32"])
    worst["decode out"] = float((out.float() - want_o.float()).abs().max())
    worst["decode lse"] = float((lse - want_l).abs().max())
    check(int(lengths.min()) == int(lengths.max()) == S + steps,
          f"the last decode step attends {S + steps} keys: {lengths}")
    print(f"serve: the last layer's last prefill and decode attention "
          f"calls == plain versions on their own inputs (max |err| "
          f"{worst})")

    serve_teacher_forcing(torch, "serve", model, params, tokens,
                          gen_tokens, step1["logits"], SERVE_TF_TOL,
                          SERVE_TF_MEAN_TOL)
    numbers = serve_numbers(torch, "serve", model, params, tokens, res,
                            args.gen, card)
    return counts, numbers


def serve_teacher_forcing(torch, label, model, params, tokens, gen_tokens,
                          step1_logits, tol, mean_tol):
    """Decode step 1 (the first generated token, at position S) against a
    full forward over the prompt and that token: the largest and the mean
    |diff| must stay within ``tol`` and ``mean_tol`` of the logits' std.
    Returns the numbers."""
    S = tokens.shape[1]
    full = model.forward_train(params, {"tokens": torch.cat(
        [tokens, gen_tokens[:, :1]], dim=1)})[:, S].float()
    diff = (full - step1_logits).abs()
    scale = float(full.std())
    tf = {"max": float(diff.max()), "mean": float(diff.mean()),
          "logit std": scale,
          "argmax agree": float((full.argmax(-1) == step1_logits
                                 .argmax(-1)).float().mean())}
    print(f"{label}: teacher-forced decode step 1 against the full forward "
          f"over prompt + token ({S + 1} tokens): |diff| {tf}")
    check(tf["max"] <= tol * scale and tf["mean"] <= mean_tol * scale,
          f"{label}: teacher-forced |diff| max {tf['max']:.4g} > {tol} x "
          f"or mean {tf['mean']:.4g} > {mean_tol} x the logits' std "
          f"{scale:.4g}")
    return tf


def serve_numbers(torch, label, model, params, tokens, res, gen_len, card):
    """The serve metrics of one ``serve`` run, beside the device's own time
    for one prefill and one decode step: each captured in a CUDA graph and
    replayed, so no host work sits between its kernels; against the host
    clock, the rest is the device idling while Python dispatches."""
    B, S = tokens.shape
    steps = gen_len - 1
    cap = S + gen_len + 1
    cache, last = res["cache"], res["tokens"][:, -1:]
    device = {
        "prefill_device_ms": graph_ms(torch, lambda: model.prefill(
            params, {"tokens": tokens}, cache_len=cap), 1),
        "decode_step_device_ms": graph_ms(torch, lambda: model.decode_step(
            params, cache, last), 1, replays=20)}

    prefill_ms = res["prefill_s"] * 1e3
    decode_ms = res["decode_s"] * 1e3
    numbers = {"prefill_ms": prefill_ms,
               "prefill_tokens_per_s": B * S / res["prefill_s"],
               "decode_ms": decode_ms, "decode_ms_per_step": decode_ms / steps,
               "decode_tokens_per_s": B * steps / res["decode_s"],
               **device, "card": card}
    numbers["prefill_device_idle_share"] = (
        1 - device["prefill_device_ms"] / prefill_ms)
    numbers["decode_device_idle_share"] = (
        1 - device["decode_step_device_ms"] / numbers["decode_ms_per_step"])
    print(f"{label}: prefill {prefill_ms:.2f} ms "
          f"({numbers['prefill_tokens_per_s']:.0f} tok/s); decode "
          f"{decode_ms:.2f} ms for {steps} steps "
          f"({numbers['decode_ms_per_step']:.3f} ms/step, "
          f"{numbers['decode_tokens_per_s']:.1f} tok/s); on the device "
          f"alone (CUDA graph) prefill {device['prefill_device_ms']:.2f} ms, "
          f"a decode step {device['decode_step_device_ms']:.3f} ms ({card})")
    print(f"{label}: sample tokens", res["tokens"][0, :12].tolist())
    return numbers


def device_breakdown(torch, label, fn, top=6):
    """Device time of one call of ``fn`` by kernel, from a
    ``torch.profiler`` trace (CUPTI): the total, the launches, and the
    ``top`` kernels by their summed time with their launch counts.
    Returns ``{"total_ms", "launches", "top": [[name, ms, count], ...]}``;
    ``None`` (printed "not measured") where the trace holds no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print(f"{label}: device time by kernel not measured (the trace "
              f"holds no device time)")
        return None
    kernels.sort(key=lambda k: -k[1])
    total = sum(k[1] for k in kernels)
    launches = sum(k[2] for k in kernels)
    print(f"{label}: {total:.3f} ms on the device in {launches} launches "
          f"of {len(kernels)} kernels; the top {top}: " + "; ".join(
              f"{name[:70]} {ms:.3f} ms x{n}"
              for name, ms, n in kernels[:top]))
    return {"total_ms": total, "launches": launches,
            "top": [[name[:120], ms, n] for name, ms, n in kernels[:top]]}


def phase_ssm_serve(torch, card):
    """mamba2-2.7b at full width in bf16 through the serve launcher's code
    path, as ``phase_serve`` drives qwen2-0.5b: one warm-up pass, then the
    measured pass with every kernel count set to 0 just before it, read
    after the prefill and again after the decode steps. Returns (launch
    counts of the whole pass, the numbers printed)."""
    import repro_torch.models.ssm as ssm_mod
    from repro_torch.kernels.ssd_scan import ssd_ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    from repro_torch.utils import tree_map

    t0 = time.perf_counter()
    args = serve_mod.parse_args(SSM_SERVE_ARGS)
    model, params, tokens, gen = serve_mod.build(args)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = model.param_count(params)
    check(n_params == 2_702_579_200, f"mamba2-2.7b has {n_params} params")
    slot = params["layers"]["slot_0"]
    mamba = slot["mamba"]
    bf16 = [params["embed"], mamba["in_proj"], mamba["conv_w"],
            mamba["conv_b"], mamba["out_proj"]]
    f32 = [mamba["dt_bias"], mamba["A_log"], mamba["D"],
           mamba["norm_scale"]["scale"], slot["norm1"]["scale"],
           params["final_norm"]["scale"]]
    check(all(t.dtype == torch.bfloat16 for t in bf16)
          and all(t.dtype == torch.float32 for t in f32),
          "bf16 weights; f32 dt_bias, A_log, D and norm scales")
    B, S = tokens.shape
    print(f"ssm serve: {cfg.name} ({n_params:,} params, {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.ssm_heads} heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, {cfg.ssm_ngroups} "
          f"group, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), batch {B}, prompt {S}, gen {args.gen}; set-up "
          f"{time.perf_counter() - t0:.2f} s")

    seen = {}

    def recorder(*a, **kw):
        out = originals(*a, **kw)
        seen["ssd"] = (a, kw, out)
        return out

    kernel_ops = ops()
    finite, step1, prefill_counts = [], {}, {}

    def on_step(i, logits):
        finite.append(torch.isfinite(logits).all())
        if i == 0:
            prefill_counts.update(
                {name: op.launches for name, op in kernel_ops.items()})
        if i == 1:
            step1["logits"] = logits[:, 0].float().clone()

    originals = ssm_mod.ssd_scan
    ssm_mod.ssd_scan = recorder
    try:
        warm = serve_mod.serve(model, params, tokens, args.gen,
                               args.temperature, gen)
        del warm
        finite.clear()
        torch.cuda.synchronize()
        reset_counts(kernel_ops)
        res = serve_mod.serve(model, params, tokens, args.gen,
                              args.temperature, gen, on_step=on_step)
        counts = {name: op.launches for name, op in kernel_ops.items()}
        merges = kernel_ops["decode_attention"].merge_launches
    finally:
        ssm_mod.ssd_scan = originals
    steps = args.gen - 1
    want = {name: 0 for name in counts}
    want["ssd_scan"] = cfg.num_layers
    decode_counts = {name: counts[name] - prefill_counts[name]
                     for name in counts}
    check(prefill_counts == want and counts == want and merges == 0,
          f"ssm serve launches: prefill {prefill_counts}, whole pass "
          f"{counts}, merges {merges}; want {want} and none in decode")
    print(f"ssm serve launches: prefill {prefill_counts}; {steps} decode "
          f"steps {decode_counts} (ssd_scan: 1 prefill x {cfg.num_layers} "
          f"layers; decode steps the plain recurrence)")
    check(len(finite) == args.gen and all(bool(f) for f in finite),
          "finite logits at the prefill and every decode step")
    gen_tokens = res["tokens"]
    check(gen_tokens.shape == (B, args.gen)
          and bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size))
                   .all()), f"tokens {tuple(gen_tokens.shape)} in range")

    # the last layer's prefill scan against the plain version on its own
    # inputs; x, B and C reach the kernel as views of the conv output
    (x, dt, A, Bm, Cm, D), kw, (y, st) = seen["ssd"]
    check(tuple(x.shape) == (B, S, cfg.ssm_heads, cfg.ssm_head_dim)
          and kw == {"chunk": cfg.ssm_chunk} and not x.is_contiguous()
          and x.stride(1) == cfg.d_inner + 2 * cfg.ssm_ngroups
          * cfg.ssm_state, f"the last scan's x {tuple(x.shape)} strides "
          f"{x.stride()}, {kw}")
    worst = {}
    _hold_ssd(torch, (y, st), ssd_ref(x, dt, A, Bm, Cm, D),
              torch.bfloat16, worst)
    print(f"ssm serve: the last layer's prefill ssd_scan == plain version "
          f"on its own inputs (x read in place, strides {x.stride()}; max "
          f"|err| {worst})")

    # teacher forcing. The full forward over S + 1 = 513 tokens runs the
    # scan in chunks of 256, 256 and 1 rows: the kernel's ragged last
    # chunk, whose row 512 must give what the decode recurrence gives from
    # the prefill's state. Checked on the served bf16 run, and tighter on
    # the same weights in f32 (the kernel's f32 route)
    tf_bf16 = serve_teacher_forcing(
        torch, "ssm serve (bf16)", model, params, tokens, gen_tokens,
        step1["logits"], SSM_TF_BF16_TOL, SSM_TF_BF16_MEAN_TOL)
    model32 = build_model(cfg.replace(dtype="float32"))
    params32 = tree_map(lambda t: t.float(), params)
    _, cache32 = model32.prefill(params32, {"tokens": tokens})
    step1_32, _ = model32.decode_step(params32, cache32, gen_tokens[:, :1])
    del cache32
    tf_f32 = serve_teacher_forcing(
        torch, "ssm serve (f32 weights)", model32, params32, tokens,
        gen_tokens, step1_32[:, 0].float(), SSM_TF_TOL, SSM_TF_MEAN_TOL)
    del params32
    numbers = serve_numbers(torch, "ssm serve", model, params, tokens, res,
                            args.gen, card)
    cache, last = res["cache"], gen_tokens[:, -1:]
    numbers.update(
        teacher_forcing_bf16=tf_bf16, teacher_forcing_f32=tf_f32,
        prefill_by_kernel=device_breakdown(
            torch, "ssm serve prefill", lambda: model.prefill(
                params, {"tokens": tokens})),
        decode_step_by_kernel=device_breakdown(
            torch, "ssm serve decode step", lambda: model.decode_step(
                params, cache, last)))
    return counts, numbers


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
    check_flash_attention(torch)
    check_decode_attention(torch)
    check_ssd_scan(torch)

    model = build_model(get_config("fedtest-cnn"))
    shapes = [tuple(s) for s in tree_leaves(model.param_shapes())]
    leaves = [math.prod(s) for s in shapes]
    check_weighted_aggregate_grouped(torch, shapes)
    dim = flat_update_dim(model)
    padded_dim = COMPRESSORS.build("int8", {}, dict(dim=dim)).padded_dim
    rows = phase_times(torch, peaks[:2], shapes, dim, padded_dim)
    rows.update(phase_attention_times(torch, peaks))
    rows.update(phase_ssd_times(torch, peaks))

    launches, walls = {}, {}
    for path, argv, op_name in PATHS:
        launches[op_name], walls[path] = phase_path(torch, path, argv,
                                                    op_name)
    repro = phase_reproducible(torch, card)
    serve_counts, serve_out = phase_serve(torch, card)
    launches["flash_attention"] = serve_counts["flash_attention"]
    launches["decode_attention"] = serve_counts["decode_attention"]
    ssm_counts, ssm_out = phase_ssm_serve(torch, card)
    launches["ssd_scan"] = ssm_counts["ssd_scan"]

    def entry(name, path_rows, shape):
        def total(key):    # None where no PyTorch call computes the same
            if any(key not in r for r in path_rows):
                return None
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
        # one round of path A: its 10 leaves in one grouped launch, C=20
        entry("weighted_aggregate", rows["weighted_aggregate"][:1],
              "C=20, one grouped launch a round, M=" + "+".join(
                  str(m) for m in leaves)),
        # one round of path B / C: one launch on the [20, D] matrix
        entry("robust_combine", rows["robust_combine"][:1],
              f"C=20, M={dim}, trimmed mean at {TRIM}"),
        entry("dequant_aggregate", rows["dequant_aggregate"][:1],
              f"C=20, M={padded_dim} int8, chunk 256"),
        # one call (one layer) of the serve path's prefill / decode step
        entry("flash_attention", rows["flash_attention"][:1],
              "one call: B=8, S=T=512, Hq=14, Hkv=2, D=64, bf16, causal"),
        dict(entry("decode_attention", rows["decode_attention"][:1],
                   "one call (split kernel + merge kernel): B=8, cache "
                   "545, lengths 513..543, Hq=14, Hkv=2, D=64, bf16"),
             merge_launches=serve_counts["decode_attention merge"]),
        # one call (one layer) of the Mamba2 serve path's prefill
        entry("ssd_scan", rows["ssd_scan"][:1],
              "one call: Bt=8, S=512, H=80, P=64, G=1, N=128, chunk 256, "
              "bf16")]}))
    print(json.dumps({"serve": serve_out, "ssm_serve": ssm_out,
                      "reproducible_path_a": repro}))
    print(f"chip_smoke passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
