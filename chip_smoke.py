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
   (``weighted_aggregate``: a round of path A and one of the population
   tier's C=64 cohort, one grouped launch each, beside ten ``torch.mv``
   calls; ``dequant_aggregate`` also at the cohort's [64, D_pad]) and at
   M=2**22 (``robust_combine`` also above
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
   row. Both are timed again at the shapes the LM round's cross-test
   folds them to (phases L and M below; ``ssd_scan`` with ``[Bt, H]`` A
   and D).
4. Three paths, three rounds each, of the paper's FedTest round at the
   full width of ``fedtest-cnn`` (188,810 params; 20 users, 5 testers, 3
   ``random_weights`` attackers), built by ``repro_torch.launch.train``'s
   code path on ``cuda``: A, the paper's score-weighted sum
   (``weighted_aggregate``); B, the coordinate-wise trimmed mean
   (``robust_combine``); C, the int8 compressed exchange
   (``dequant_aggregate``). Then B100, path B with 100 users (15
   attackers, the same 900 samples a user) for two rounds: the
   trimmed mean over a [100, 188,810] update matrix, the kernel above 64
   clients. Every value must be finite, the weights must
   sum to 1, the launch counts must show each path went through its
   kernel and no other, and the last step-7 output must equal the plain
   version's on the same inputs. Then D, path A with the paper's
   baseline ``accuracy_based`` (every model evaluated on the server's
   held-out rows), the ``score_weighted`` selector and each tester's eval
   rows redrawn every second round: ``weighted_aggregate`` once a round
   and no other kernel, its step table with a ``server_eval`` column.
   Then E, the coordinated adversary under failures
   (``--scenario full_collusion_vs_fedtest --fault straggler_deadline``:
   4 sybils splitting a scale-8 poison and boosting each other's
   reports, tester trust and clipped reports, stragglers past the
   deadline dropped), and F, the paper's Sec. V-C ablation
   (``--scenario paper_lying_testers``: testers 0 and 1 report uniform
   draws): ``weighted_aggregate`` once a round and no other kernel, each
   dropped client paid exactly 0 and keeping its score,
   ``dropped_fraction`` its share; each round's dropped clients,
   ``dropped_fraction`` and the coalition's weight are printed. In
   every dense path the testers must be K distinct ids. Then G, the
   reference CI's ``population-smoke`` settings through the train CLI
   (``--dataset mnist_like --lr 0.1 --population 4096 --cohort 32
   --testers 8 --testers-from-cohort --attack sign_flip --malicious
   820``, 12 rounds of 4 steps of batch 8, 40 samples a client,
   ``fedtest-cnn-mnist`` at full width): ``weighted_aggregate`` once a
   round on the cohort's [32] stack and no other kernel, the testers
   from the cohort, at most 32 filled slots, the weights exactly 0 and
   the scores unchanged outside the cohort; each round's malicious
   weight is printed. Then phase R, the multi-round driver
   (``--rounds-per-call``): each of A-G, from the trainer its phase ran
   (built anew), and G again with ``--attack random_weights`` (the
   population round's keyed noise in the graph; G's replays' metrics
   held to its eager rounds' as well), 5 eager rounds from the seed (the second under
   ``torch.cuda.set_sync_debug_mode("error")``) against 5 rounds at
   ``rounds_per_call`` = 4, one chunk of 4 replays of one CUDA graph of
   a round and one eager round (on A 9 rounds, two chunks on the same
   graph): the states bitwise equal (params, score fields, the
   generator's state, C's error feedback), the graph captured once, the
   wrappers' counters at the warm-up's and the capture's calls alone,
   and one replay's trace (``torch.profiler``) holding the path's kernel
   once a round (the wrappers never see a replay); eager, graphed (4
   replays on the host clock) and device ms a round (CUDA events around
   each replay) are printed. Then the same driver on each seam a round
   reads its index or a host-made value through (``round_robin``,
   ``coverage``, ``fixed``, ``targeted``, dropout with int8, trust and
   eval resampling, lying testers), on a small MLP: 12 eager rounds
   against chunks through a checkpoint and a resume, bitwise. Then the
   LM round through the same launcher
   (``--dataset lm``, the FedConfig and TrainConfig of
   ``examples/federated_llm.py``: 4 users, 2 testers, 1
   ``random_weights`` attacker, 8 AdamW steps of 16 sequences of 64
   tokens), 3 rounds each: L, ``qwen2-0.5b`` at full width and depth
   (494,032,768 params, bf16); M, ``mamba2-2.7b`` at its published
   widths with 8 of its 64 layers (a ``reduced`` line says why). Local
   training differentiates the kernels' plain-op twins and must launch
   no kernel; a cross-test and the global eval must launch
   ``flash_attention`` (L) or ``ssd_scan`` (M) once a layer, the vmap
   rule folding testers x clients x eval rows into one batch; step 7
   ``weighted_aggregate`` once a table (the bf16 leaves, the f32 ones);
   no other kernel. The last cross-test's first folded launch must equal
   its (tester, client) blocks launched one by one, bitwise, and the
   plain version within the kernel checks' tolerances (in M each block
   with its client's own A and D). L's first 2 rounds then run again as
   one chunk of 2 replays of a graph of its round (the cache emptied
   first): bitwise equal, its peak and a replay's device time printed.
   Then LP, L's round on the population tier (256 clients, a cohort of
   4 a round, 2 testers from it, 64 ``random_weights`` attackers): a
   cross-test launches flash twice a layer (the cohort's fold, then the
   global model's column), the folded launch equal to its blocks, path
   G's cohort checks, and its first 2 rounds as one chunk, bitwise. Then
   VR, pixtral-12b's round on its text at its published widths with 1
   of its 40 layers (3 users under SGD, 2 rounds; a ``reduced`` line
   says why): the folded flash launch at D = 128 equal to its blocks,
   ``weighted_aggregate`` once a table, and every client's trained
   ``patch_proj`` (no gradient reaches it) bitwise the global one.
   Then the CI job itself as
   ``repro.launch.federated --population`` builds it (the CNN cut to
   (8, 16, 16) channels over a synthetic MNIST-like population, 12
   rounds): ``weighted_aggregate`` once a round and no other kernel, and
   the mean malicious weight below the attackers' share (0.2002); the
   CI's gate (the last round below 0.1) is printed, not held; the same
   rounds again as 3 chunks of 4 replays of one CUDA graph, the state
   and every round's malicious weight bitwise the eager run's; and once
   more with its slots trained in groups of 8 (``train_block``, P3's
   reference). Then the
   population phases:
   ``PopulationTrainer`` over ``make_synthetic_population`` (shards
   drawn on gather from keyed Philox counters, on the card; a cohort's
   draw equal to the CPU's, the labels bitwise), ``fedtest-cnn`` at full
   width, a cohort of 64, 8
   testers from it, cross-testing in tiles of 16, ``random_weights``
   from 20 % of the clients, 4 rounds at N = 1,000 and at N = 100,000:
   the checks of G (every honest member's slot left bitwise by the
   attack, every malicious member's corrupted), and the allocator's peak
   at N = 100,000 less than 1 GiB above the peak at N = 1,000; then int8 at N = 10,000: ``dequant_aggregate``
   once a round and no other kernel, and 1,000 error-feedback rows of
   clients outside each round's cohort unchanged, bitwise. At N = 100,000
   and in int8 the 4 rounds run again from the same init as 1 eager
   round (under ``torch.cuda.set_sync_debug_mode("error")``) and a chunk
   of 3 replays of one CUDA graph of the round: bitwise (params, scores,
   error feedback, generator, every round's metrics), one capture, the
   aggregation kernel once a replay by the profiler and its output equal
   to the plain version; eager, graphed and device ms a round, the
   kernels a replay and the peak printed. Then phase P,
   the pod round (one client a rank of a ``torch.distributed`` group; 4
   ranks, each a process, share the card through gloo, every collective
   staged through host memory). P1: ``PodTrainer``, the pod CLI's
   driver, on ``fedtest-cnn`` at full width (cifar_like, 1,000 samples
   a client, K = 4, one sign_flip attacker, 10 steps of 32), 3 rounds
   each of ring and allgather: ring == allgather bitwise (params,
   weights, [K, N] counts, the generator), every rank holding rank 0's
   params; against the local backend on the same draws with its clients
   trained one at a time, as the ranks train them, the counts, the
   weights and the params bitwise; the local backend's vmapped run
   printed beside it, and where it parts held by ``vmap_witness``
   (round 1's SGD steps both ways: the params within rounding until a
   pre-activation within rounding of a ReLU's 0 or a max-pool tie routes
   a gradient otherwise; in float64 no flip and the params within
   1e-9); ``weighted_aggregate`` once a round on every rank
   and no other kernel, its last output against the plain version; round
   ms, the exchange's share, bytes staged a round and each rank's peak
   printed. The same group then runs the reference crosstest schedule on
   both exchanges (bitwise the batched runs), the mutual_boost coalition
   for 8 rounds (its malicious weight printed beside the CI's 0.1), and a
   ring round of ``trimmed_mean_coord``: ``robust_combine`` once on every
   rank on the gathered [4, 188,810] matrix. P2 and P3, all at once: the
   reference CI's pod-smoke commands (ring with sign_flip; allgather at
   participation 0.75; int8 for 6 rounds, ``dequant_aggregate`` once a
   round) and its population-smoke command (C = 32 over 4 ranks, 12
   rounds, its malicious weights bitwise the unsharded CI run's above
   with its slots trained in the 4 ranks' groups of 8: a vmap's width
   changes how the card rounds a slot's training, and the one-group
   run's series parts from the sharded one by rounding)
   through ``python -m repro_torch.launch.federated --dist-backend
   gloo``, each exiting 0 with rank 0's kernel once a round; meanwhile
   P1's round at world size 1 under nccl, whose collectives run on the
   card (a four-card run waits for a four-chip cell). Then the paper's
   comparison (Figs. 4-5): ``repro_torch.examples.fedtest_cifar``'s
   ``run_curve`` at its full scale, 3 rounds each of ``fedtest``,
   ``fedavg`` and ``accuracy_based`` against 3 attackers at scale 4; every
   value must be finite and FedTest's last malicious weight must be below
   FedAvg's. Then path A twice more from one seed:
   its global params and score state must be bitwise equal, and its
   rounds are timed again with ``cudnn.deterministic`` off, for what the
   deterministic algorithms cost. Then durability, on path E's flags: 5
   rounds unbroken against 3, a checkpoint (``CheckpointManager``), a
   trainer built anew restoring it, and 2 more: params, score fields and
   generator state bitwise equal; then the train CLI in a subprocess,
   sent SIGTERM after its first checkpoint (exit 1, the round it reached
   saved), and ``--resume`` to round 5 in a second one: its checkpoint
   equal to the unbroken run, bitwise. Save, restore and SIGTERM-to-exit
   times are printed. Then a checkpoint of the reduced ``qwen2-0.5b``
   served with ``--ckpt-dir``: tokens and logits equal to serving its
   params directly.
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
6. The moe and hybrid families, after every phase above, each through
   the same serve code path with the same batch, prompt and generation
   in bf16 (the prefill's MoE by capacity, decode dropless):
   ``granite-moe-1b-a400m`` (24 layers, 32 experts top-8, D = 64) and
   ``qwen3-moe-30b-a3b`` (48 layers, 128 experts top-8, D = 128,
   qk-norm; 61.1 GB of weights) at full width and depth, their
   ``param_count()`` the reference's; then one period of
   ``jamba-1.5-large-398b``'s layout (8 layers: attention at slot 4, MoE
   on the odd slots, 16 experts top-2) at a quarter of its d_model, d_ff
   and heads, which a ``reduced`` line explains. Launches:
   ``flash_attention`` once an attention layer and ``ssd_scan`` once a
   mamba layer a prefill, ``decode_attention`` and its merge once an
   attention layer a decode step, no other kernel; each kernel's last
   call against its plain version; teacher forcing on the model rebuilt
   with a dropless prefill, in bf16 and, where it fits, on the weights
   upcast to f32; host and device times, the idle share and the
   allocator peak (qwen3-moe's decode step also by kernel). Last, N: the
   LM round of phase L on ``granite-moe-1b-a400m`` with 8 of its 24
   layers (a ``reduced`` line gives the memory reckoning), held as L is,
   and the global model's ``moe_aux``.
7. The encdec and vlm families, last, through the same serve code path
   in bf16 at full width and depth, weights from the seed, 32 greedy
   tokens: W, ``whisper-base`` (70,915,584 params) over batch 8 x 1,500
   stub frames and a 384-token prompt: ``flash_attention`` 18 launches a
   prefill (6 encoder, non-causal; 6 causal self-attention; 6
   cross-attention against the 1,500 encoder rows) and 6 a decode step
   (cross-attention, one query), ``decode_attention`` and its merge 6 a
   step; V, ``pixtral-12b`` (12,273,996,800 params, 24.5 GB) over 1,024
   stub patches before a 512-token prompt: ``flash_attention`` 40 a
   prefill (D = 128, group 4), ``decode_attention`` and its merge 40 a
   step over a 1,569-row cache; no other kernel. The last call of each
   flash shape and the last decode call against the plain versions;
   teacher forcing in bf16 and on the weights upcast to f32 (V's at
   P + S, on 2 of its 8 sequences); host and device times, the idle
   share, the decode step's byte bound, the prefill's and a decode
   step's device time by kernel and the allocator peak. Their kernel shapes are checked and timed in
   phases 2 and 3 (groups 8 / 8 and 32 / 8; S = 384 and S = 1 against T
   = 1,500 non-causal; a decode cache of 1,569 rows at D = 128).
T. The dry-run and roofline tooling (slice 16): the card's ``Chip``
   (``repro_torch.roofline.chip_for``, the figures every bound above
   reads), its ``hbm_bytes`` the device's ``total_memory``; the dry-run
   CLI (``python -m repro_torch.launch.dryrun``, started in the
   background as the run begins, two CPU processes that see no card) of
   ``qwen2-72b decode_32k --mesh single`` (with its depth extrapolation)
   and ``qwen3-moe-30b-a3b train_4k --mesh multi --no-extrapolate``:
   ``ok`` on 256 and 512 chips, collective bytes above 0; the report's
   tables built from their artifacts and each run's wall; then the
   dry-run of the serve phase's qwen2-0.5b prefill (bf16, batch 8,
   prompt 512) on one card's mesh (``make_host_mesh``), its three
   roofline terms printed beside the device ms the serve phase measured
   for that prefill (information, not a check).

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import gc
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 3
# the run-only flags of every round path; paths E and F take their
# FedConfig from a scenario preset, whose fields --users, --malicious,
# --attack, --aggregator and --selector would override
RUN_ARGS = [
    "--device", "cuda", "--arch", "fedtest-cnn", "--dataset", "cifar_like",
    "--samples", "20000", "--local-steps", "10", "--batch", "32",
    "--lr", "0.05", "--optimizer", "sgd", "--rounds", str(ROUNDS)]
MAIN_PATH_ARGS = RUN_ARGS + [
    "--users", "20", "--testers", "5", "--malicious", "3",
    "--attack", "random_weights", "--aggregator", "fedtest",
    "--selector", "rotating"]
# E: the coordinated adversary under failures (20 users, K=5, 4 sybils
# splitting a scale-8 poison and boosting each other, tester trust with
# decay 0.3 and reports clipped at 0.2), stragglers past the deadline
# dropped; F: the paper's Sec. V-C ablation (3 random_weights attackers,
# testers 0 and 1 reporting uniform draws)
E_ARGS = RUN_ARGS + ["--scenario", "full_collusion_vs_fedtest", "--fault",
                     "straggler_deadline"]
F_ARGS = RUN_ARGS + ["--scenario", "paper_lying_testers"]
# the reference CI's population-smoke job (.github/workflows/ci.yml,
# repro.launch.federated --population): 4,096 clients, a cohort of 32 a
# round (participation 32/4096), 8 testers recruited from it, 820
# sign-flippers (20 %), 12 rounds of 4 local steps of batch 8, sgd at lr
# 0.1 on MNIST-like data; its gate: the last round's malicious weight
# below 0.1. Here the gate is reported, not held: the port misses it at
# the smoke's seed on the card, and the reference's own command misses it
# at a third of its seeds (ROADMAP.md queue 3); the run's mean malicious
# weight must stay below the attackers' share, which a FedAvg by sample
# count pays them
CI_POPULATION, CI_COHORT, CI_TESTERS, CI_MALICIOUS = 4096, 32, 8, 820
CI_STEPS, CI_BATCH, CI_LR, CI_ROUNDS, CI_GATE = 4, 8, 0.1, 12, 0.1
CI_RPC = 4                # the job again as chunks of CI_RPC replays
# the ranks the pod CLI shards the job's cohort over (P3); the unsharded
# reference trains its slots in their groups of CI_COHORT // CI_RANKS
CI_RANKS = 4
# G: that job's population, cohort, testers, attack, dataset and lr
# through the train CLI, which builds fedtest-cnn-mnist at full width over
# the dense dataset (40 samples a client); its malicious weight is
# reported beside the gate, not gated: the reference's own train CLI ends
# these flags above it (PERF.md)
G_ARGS = RUN_ARGS + [
    "--dataset", "mnist_like", "--lr", str(CI_LR),
    "--population", str(CI_POPULATION), "--cohort", str(CI_COHORT),
    "--testers", str(CI_TESTERS), "--testers-from-cohort",
    "--attack", "sign_flip", "--malicious", str(CI_MALICIOUS),
    "--local-steps", str(CI_STEPS), "--batch", str(CI_BATCH),
    "--samples", str(CI_POPULATION * 40), "--rounds", str(CI_ROUNDS)]
# the full-width models of the paths
FULL_WIDTH_PARAMS = {"fedtest-cnn": 188_810, "fedtest-cnn-mnist": 188_234}
# the population phases: fedtest-cnn at full width over a synthetic
# population of POP_SIZES clients, a cohort of POP_COHORT, POP_TESTERS
# testers from it, cross-testing in tiles of POP_BLOCK models,
# random_weights from 20 % of the clients; the compressed phase (int8) at
# POP_INT8_SIZE clients, where the [N, D] error feedback (7.6 GB) fits
POP_SIZES = (1_000, 100_000)
POP_INT8_SIZE = 10_000
POP_COHORT, POP_TESTERS, POP_BLOCK, POP_ROUNDS = 64, 8, 16, 4
# the chunk phases (N = 100,000 and int8): 1 eager round and a chunk of
# POP_RPC replays against the POP_ROUNDS eager rounds
POP_RPC = POP_ROUNDS - 1
POP_PER_CLIENT = 16
POP_UNTOUCHED = 1_000     # non-cohort error-feedback rows checked a round
TRIM = 0.2
COMBINE_ARGS = ["--aggregator", "trimmed_mean_coord", "--agg-kwargs",
                json.dumps({"trim_fraction": TRIM, "score_gate": 0.5})]
# (path, CLI arguments, the kernel op the path must launch, rounds). B100:
# a dense round of 100 users, as in McMahan et al. 2017, the attackers 15 %
# as in B, and 100,000 samples, so that a user holds as many as in B; two
# rounds, to keep the smoke within its time. D: path A with the paper's
# accuracy-based baseline, score-weighted testers and eval rows redrawn
# every second round
PATHS = (
    ("A", MAIN_PATH_ARGS, "weighted_aggregate", ROUNDS),
    ("B", MAIN_PATH_ARGS + COMBINE_ARGS, "robust_combine", ROUNDS),
    ("C", MAIN_PATH_ARGS + ["--compressor", "int8"], "dequant_aggregate",
     ROUNDS),
    ("B100", MAIN_PATH_ARGS + COMBINE_ARGS + [
        "--users", "100", "--malicious", "15", "--samples", "100000",
        "--rounds", "2"], "robust_combine", 2),
    ("D", MAIN_PATH_ARGS + ["--aggregator", "accuracy_based", "--selector",
                            "score_weighted", "--eval-resample-every", "2"],
     "weighted_aggregate", ROUNDS),
    ("E", E_ARGS, "weighted_aggregate", ROUNDS),
    ("F", F_ARGS, "weighted_aggregate", ROUNDS),
    ("G", G_ARGS, "weighted_aggregate", CI_ROUNDS),
)
# the LM federated round (examples/federated_llm.py's FedConfig and
# TrainConfig through the train CLI): L, qwen2-0.5b at full width and
# depth; M, mamba2-2.7b at its published widths with M_LAYERS of its 64
# layers (AdamW for 4 clients at full depth would not fit the card)
LM_ROUNDS = 3
LM_ARGS = ["--device", "cuda", "--dataset", "lm", "--users", "4",
           "--testers", "2", "--malicious", "1", "--attack",
           "random_weights", "--local-steps", "8", "--batch", "16",
           "--optimizer", "adamw", "--lr", "2e-3", "--rounds",
           str(LM_ROUNDS)]
# LP: phase L's round on the population tier, a cohort of 4 from 256
# clients (testers from the cohort, a quarter of them random_weights),
# otherwise LM_ARGS; VR: pixtral-12b's round on its text at its published
# widths with VR_LAYERS of its 40 layers, 3 users under SGD, 2 rounds
LP_ARGS = (["--arch", "qwen2-0.5b"]
           + [a for i, a in enumerate(LM_ARGS)
              if a not in ("--users", "--testers", "--malicious")
              and LM_ARGS[i - 1] not in ("--users", "--testers",
                                         "--malicious")]
           + ["--population", "256", "--cohort", "4", "--testers", "2",
              "--testers-from-cohort", "--malicious", "64"])
VR_LAYERS, VR_ROUNDS, VLM_KV_HEADS = 1, 2, 8
VR_ARGS = ["--arch", "pixtral-12b", "--device", "cuda", "--dataset", "lm",
           "--users", "3", "--testers", "2", "--malicious", "1", "--attack",
           "random_weights", "--local-steps", "4", "--batch", "16",
           "--optimizer", "sgd", "--rounds", str(VR_ROUNDS)]
M_LAYERS = 8
LM_PHASES = (("L", ["--arch", "qwen2-0.5b"] + LM_ARGS, "flash_attention",
              {}),
             ("M", ["--arch", "mamba2-2.7b"] + LM_ARGS, "ssd_scan",
              {"num_layers": M_LAYERS}))
# phase R, the multi-round driver: each of paths A-F (PATHS less B100 and
# G) for RPC + 1 rounds at --rounds-per-call RPC, one replayed chunk of
# one CUDA graph of a round and one eager round (RPC_REUSE, two chunks:
# the second reuses the first's buffers and graph), against as many eager
# rounds from the same seed; the kernel each path's graph launches, by
# the name a profiler trace gives it. Phase L's chunk: RPC_LM rounds
RPC, RPC_LM, RPC_REUSE = 4, 2, "A"
RPC_PATHS = ("A", "B", "C", "D", "E", "F", "G")
# G again with the keyed noise of random_weights in its graph
G_NOISE_ARGS = G_ARGS + ["--attack", "random_weights"]
# phase R's seams, each a reader of the round index or of a per-round
# host value, on a small MLP: SEAM_ROUNDS eager rounds against a trainer
# that runs SEAM_SPLIT rounds (a chunk) and checkpoints, and a second
# that restores it and runs on to SEAM_ROUNDS (two chunks of its graph)
SEAM_ROUNDS, SEAM_SPLIT = 12, 4
SEAMS = {
    "round_robin": dict(selector="round_robin"),
    "coverage": dict(selector="coverage"),      # a cycle of 3 rounds
    "fixed": dict(selector="fixed", selector_kwargs={"indices": (4, 1)}),
    "targeted": dict(fault="targeted", participation=0.5,
                     fault_kwargs={"size": 2, "start_round": 5}),
    "dropout_int8_trust_resample": dict(
        fault="dropout", fault_rate=0.3, participation=0.75,
        compressor="int8", aggregator_kwargs={"use_trust": True}),
    "liars_score_weighted": dict(selector="score_weighted",
                                 lying_testers=1),
}
SEAM_RESAMPLE = {"dropout_int8_trust_resample": 2}
GRAPH_KERNELS = {"weighted_aggregate": "wagg_group_kernel",
                 "robust_combine": "robust_kernel",
                 "dequant_aggregate": "dqagg_"}
# the durability phase: path E unbroken for DURABLE_ROUNDS rounds, against
# DURABLE_SPLIT rounds, a checkpoint, a new trainer restoring it and the
# rest; then the CLI killed by SIGTERM after its first checkpoint and
# resumed to DURABLE_ROUNDS
DURABLE_ROUNDS, DURABLE_SPLIT = 5, 3
# the paper's comparison (Figs. 4-5): rounds of each curve, attackers
COMPARE_ROUNDS, COMPARE_MALICIOUS = 3, 3
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

# the moe and hybrid families (slice 12), after every earlier phase: serve
# at the serve phases' batch, prompt and generation, bf16, weights from
# the seed. granite-moe-1b-a400m and qwen3-moe-30b-a3b at full width and
# depth (their param counts the reference's); Jamba's period stack as one
# period of jamba-1.5-large-398b's layout (8 layers, attention at slot 4,
# MoE on the odd slots, 16 experts top-2, head_dim 128, ssm_head_dim 64,
# ssm_state 16) at a quarter of its d_model, d_ff and heads
MOE_SERVE_ARGS = ["--device", "cuda", "--batch", "8", "--prompt-len", "512",
                  "--gen", "32", "--temperature", "0", "--seed", "0"]
JAMBA_PERIOD = dict(num_layers=8, d_model=2048, d_ff=6144, num_heads=16,
                    num_kv_heads=2)
# (label, arch, config overrides, the reference's count_params_analytic at
# full width; None for the cut Jamba period)
MOE_SERVES = (
    ("granite serve", "granite-moe-1b-a400m", {}, 1_334_628_352),
    ("qwen3-moe serve", "qwen3-moe-30b-a3b", {}, 30_532_122_624),
    ("jamba period serve", "jamba-1.5-large-398b", JAMBA_PERIOD, None))
# teacher forcing of a MoE model (its prefill dropless, as decode is): the
# bf16 bounds of the dense serve phase would fail a step whose router
# picks another expert than the full forward's for one token in one layer,
# which bf16 rounding at other places may do (a pick near a tie moves the
# output by the gap of two small gates); these leave that and still fail
# a wrong expert bank or hand-off, which moves the logits by their std.
# Jamba's bf16 run takes the Mamba2 phase's bounds; every model whose f32
# copy fits is checked again in f32 at the Mamba2 f32 bounds
MOE_TF_TOL, MOE_TF_MEAN_TOL = 0.5, 0.05
# the LM round on granite-moe-1b-a400m: phase L's flags, 8 of 24 layers.
# At 12 layers AdamW's step for 4 clients peaked at 66.7 GiB allocated
# with 77 GiB reserved and the allocator retrying, and one run on an
# H100 80GB ran out of memory there (PERF.md, PR 26)
N_LAYERS = 8
# the encdec and vlm families (slice 13), after every earlier phase, in
# bf16 with weights from the seed, each at full width and depth: W,
# whisper-base over 1,500 stub frames, a 384-token prompt and 32 greedy
# tokens (384 + 32 + 1 rows stay inside its 448-row position table); V,
# pixtral-12b over 1,024 stub patches before a 512-token prompt, 32 greedy
# tokens, a cache of PIXTRAL_CACHE rows. (label, CLI arguments, the
# reference's count_params_analytic)
FRONTEND_ARGS = ["--device", "cuda", "--batch", "8", "--gen", "32",
                 "--temperature", "0", "--seed", "0"]
FRONTEND_SERVES = (
    ("W", ["--arch", "whisper-base", "--prompt-len", "384"] + FRONTEND_ARGS,
     70_915_584),
    ("V", ["--arch", "pixtral-12b", "--prompt-len", "512"] + FRONTEND_ARGS,
     12_273_996_800))
PIXTRAL_CACHE = 1024 + 512 + 32 + 1
# pixtral's f32 teacher forcing runs on this many of the 8 sequences: its
# f32 weights (49.1 GB) replace the bf16 ones, leaf by leaf
V_F32_ROWS = 2

# phase P, the pod round (slice 15): one client a rank of a
# torch.distributed group, POD_N ranks sharing the card through gloo with
# every collective staged through host memory. P1: PodTrainer (the pod
# CLI's driver) on fedtest-cnn at full width (cifar_like, 1,000 samples
# a client as in path A), K = 4, one sign_flip attacker, POD_ROUNDS
# rounds each of ring and allgather, held against the local backend on
# the same draws; then one round of ring with trimmed_mean_coord; then
# one round at world size 1 under nccl. P2: the reference CI's pod-smoke
# commands through the pod CLI; P3: its population-smoke command
POD_N, POD_ROUNDS, POD_SAMPLES, POD_EVAL = 4, 3, 4000, 256
POD_FED = dict(num_users=POD_N, num_testers=POD_N, num_malicious=1,
               attack="sign_flip", local_steps=10, seed=0)
POD_COMBINE = dict(aggregator="trimmed_mean_coord",
                   aggregator_kwargs={"trim_fraction": TRIM,
                                      "score_gate": 0.5})
POD_TRAIN = dict(optimizer="sgd", lr=0.05, schedule="constant",
                 batch_size=32, grad_clip=0.0)
# the vmap witness (vmap_witness): round 1's SGD steps of P1's run, the
# local backend's vmapped local phase against each client trained alone.
# The first forward, from the same params, differs by at most
# VMAP_FORWARD_RTOL of a layer's largest pre-activation; before a
# client's first flip of a gradient route its params agree within
# VMAP_ROUNDING; in float64 nothing flips and the params end within
# VMAP_F64_ATOL
VMAP_FORWARD_RTOL = 1e-5
VMAP_ROUNDING = dict(rtol=1e-5, atol=1e-6)
VMAP_F64_ATOL = 1e-9
# P1's further runs in its group: the reference crosstest schedule on
# both exchanges (bitwise the batched one) and the mutual_boost coalition
# (scenario_for_pod's refit of mutual_boost_vs_fedtest) for POD_MB_ROUNDS
POD_MB_ROUNDS = 8
# P2 and P3, the reference CI's commands through the pod CLI (the CI's
# --assert-malicious-below 0.1 is reported beside each final malicious
# weight, not held: the reference misses it on some seeds, ROADMAP queue
# 3): (name, flags, rounds, the kernel a round). P2 is cut to ring,
# allgather and int8 to keep phase P near 120 s; the CI's crosstest pair
# and its mutual_boost run are P1's reference and mutual_boost runs
POD_CLI = (
    ("ring", ["--clients", "4", "--rounds", "2", "--attack", "sign_flip",
              "--malicious", "1"], 2, "weighted_aggregate"),
    ("allgather", ["--clients", "4", "--rounds", "2", "--exchange",
                   "allgather", "--attack", "sign_flip", "--malicious", "1",
                   "--participation", "0.75"], 2, "weighted_aggregate"),
    ("int8", ["--clients", "4", "--rounds", "6", "--compressor", "int8",
              "--attack", "sign_flip", "--attack-scale", "4",
              "--malicious", "1", "--min-classes", "8", "--local-steps",
              "10", "--batch", "16"], 6, "dequant_aggregate"),
    ("population", ["--clients", str(CI_RANKS), "--population",
                    str(CI_POPULATION),
                    "--cohort", str(CI_COHORT), "--rounds", str(CI_ROUNDS),
                    "--attack", "sign_flip", "--malicious",
                    str(CI_MALICIOUS), "--testers", str(CI_TESTERS),
                    "--testers-from-cohort", "--local-steps",
                    str(CI_STEPS), "--batch", str(CI_BATCH)], CI_ROUNDS,
     "weighted_aggregate"),
)

# the L2 cache of each card repro_torch.roofline.CHIPS names (50 MB): a
# timing row whose inputs are smaller takes its calls over copies of them
# that fill it four times
L2_BYTES = 50 << 20
# phase T's dry-runs (the CLI's flags; the chips each runs on), started in
# the background as the run begins, and the serve prefill it sets beside
# one card's roofline (the serve phase's qwen2-0.5b: bf16, batch 8,
# prompt 512)
DRYRUNS = ((["--arch", "qwen2-72b", "--shape", "decode_32k", "--mesh",
             "single"], 256),
           (["--arch", "qwen3-moe-30b-a3b", "--shape", "train_4k", "--mesh",
             "multi", "--no-extrapolate"], 512))
DRYRUN_TIMEOUT_S = 1000
HOST_DRYRUN = r'''
import json
from repro_torch.config import InputShape
from repro_torch.launch.dryrun import lower_one
rec = lower_one("qwen2-0.5b", InputShape("serve_prefill", 512, 8, "prefill"),
                mesh="host", extrapolate=False)
print(json.dumps(rec))
'''


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


def card_peaks(torch):
    """The card's ``Chip`` (``repro_torch.roofline.chip_for``) and the
    peaks every bound reads from it: HBM bytes/s, f32 FLOP/s outside the
    tensor cores, bf16 FLOP/s on them (NVIDIA data sheets, dense)."""
    from repro_torch.roofline import chip_for
    chip = chip_for(torch.cuda.get_device_properties(0))
    return chip, (chip.hbm_bw, chip.peak_flops_fp32, chip.peak_flops_bf16)


def dryrun_env():
    """A dry-run subprocess's environment: the port on its path, no card
    visible (the dry-run touches no device), one thread."""
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def start_dryruns(out_dir):
    """Phase T's dry-runs through the CLI, all started at once in the
    background, each writing its log under ``out_dir``: [(flags, chips,
    process, log path, start time)]."""
    runs = []
    for flags, chips in DRYRUNS:
        log = os.path.join(out_dir, f"{flags[1]}__{flags[3]}.log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-W", "ignore", "-m",
                 "repro_torch.launch.dryrun", *flags, "--out", out_dir],
                cwd=ROOT, env=dryrun_env(), stdout=fh,
                stderr=subprocess.STDOUT)
        runs.append((flags, chips, proc, log, time.perf_counter()))
    return runs


def stop_processes(runs) -> None:
    for *_, proc, _, _ in runs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


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


def free_memory(torch) -> None:
    """Empty the allocator's cache, cuBLAS's workspaces first: cuBLAS
    keeps a 32 MiB workspace for each stream a product ran on, cut from
    the allocator's segments, and each pins its whole segment (before
    phase N, 28 of them pinned 6.6 GiB; PERF.md, PR 22)."""
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is None:
        print("this torch cannot free cuBLAS's workspaces")
    else:
        clear()
    torch.cuda.empty_cache()


def held_memory(torch, label, top=6) -> None:
    """Print the allocator's segments that keep a live block
    (``empty_cache`` frees only whole free segments): their count and
    size, and the live blocks of the largest."""
    segs = sorted((s for s in torch.cuda.memory_snapshot()
                   if s["allocated_size"]), key=lambda s: -s["total_size"])
    largest = "; ".join(
        f"{s['total_size'] / 2**20:.0f} MiB holds " + str(
            [b["size"] for b in s["blocks"]
             if b["state"] == "active_allocated"])
        for s in segs[:top])
    print(f"{label}: {len(segs)} segments keep live blocks, "
          f"{sum(s['total_size'] for s in segs) / 2**30:.3f} GiB reserved "
          f"for {sum(s['allocated_size'] for s in segs) / 2**30:.3f} GiB "
          f"live; largest: {largest or 'none'}")


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
    nvcc's register and spill report and each build's time.
    robust_combine has one kernel per C = 1..64 (and a 4-column one for C
    <= 32), one per padded size of the register tier (65..128 clients)
    and one in shared memory for C > 128: its report is summed up, the
    C=20 kernels the paths use and the padded ones must not spill. Every
    instance of the attention kernels is
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
    from repro_torch.kernels.robust_combine import REGISTER_PADS

    def timed_build(name):
        t = time.perf_counter()
        return build.build(name), time.perf_counter() - t
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(timed_build, KERNELS)))
    libs = {name: lib for name, (lib, _) in built.items()}
    print(f"built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s; nvcc s each: " + ", ".join(
              f"{name} {sec:.1f}" for name, (_, sec) in built.items())
          + " (robust_combine.cu: 25-46 s when C > 64 had one kernel)")
    prop = re.compile(r"Function properties for (\S+)\s+(\d+) bytes stack "
                      r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads\s+ptxas info\s+: Used (\d+) registers")
    for name, lib in libs.items():
        report = prop.findall(lib.with_suffix(".log").read_text())
        check(report, f"nvcc's -Xptxas -v report for {name}")
        print(f"{os.path.relpath(lib, ROOT)}: {len(report)} kernels")
        for fn, stack, stores, loads, regs in report:
            if (name != "robust_combine" or "ILi20E" in fn or int(stores)
                    or "padded" in fn or "smem" in fn):
                print(f"  {fn}: {regs} registers, {stack} bytes stack, "
                      f"{stores} bytes spill stores, {loads} bytes spill "
                      f"loads")
        spills = [(fn, int(s), int(l)) for fn, _, s, l, _ in report
                  if int(s) or int(l)]
        if name == "robust_combine":
            c20 = [fn for fn, *_ in report if "ILi20E" in fn]
            check(len(c20) == 2 and not any(fn in c20 for fn, *_ in spills),
                  f"robust_combine at C=20 spills: {spills}")
            padded = [fn for fn, *_ in report if "robust_kernel_padded" in fn]
            check(len(padded) == len(REGISTER_PADS)
                  and not any(fn in padded for fn, *_ in spills),
                  f"robust_combine's register tier {padded} spills: {spills}")
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
    # above 64 clients: the register tier's padded networks (65..128; 96
    # and 128 fill a pad exactly) and the shared-memory tier (129 up to
    # MAX_CLIENTS): NaN, +-inf, masked rows (a masked NaN among them), ties
    for C in (65, 96, 100, 128, 129, 257, MAX_CLIENTS):
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
    rtol=1e-5, atol=1e-6 (the sum over C is taken in another order). The
    kernel takes 4 columns a thread (4-byte code loads) unless the
    16-column grid has at least two blocks an SM; M runs a chunk below
    and above both edges: one wave of the 4-column grid (a block of 256
    threads an SM) and the switch to 16 columns. q starts 16-byte
    aligned, 4 bytes off (4 columns) and 1 byte off (a column a thread)."""
    from repro_torch.kernels.dequant_aggregate import (
        dequant_aggregate, dequant_aggregate_ref)
    gen = torch.Generator(device="cuda").manual_seed(3)
    calls, worst = 0, 0.0
    launches = dequant_aggregate.launches
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edges = (sms * 256 * 4, (2 * sms - 1) * 256 * 16)
    for C in (1, 3, 20):
        for chunk in (16, 100, 256):
            near = [e // chunk * chunk + d for e in edges
                    for d in (-chunk, 0, chunk)]
            for target in [chunk, 188_928, 1 << 22] + near:
                M = max(1, round(target / chunk)) * chunk
                q = torch.randint(-127, 128, (C, M), generator=gen,
                                  device="cuda", dtype=torch.int8)
                s = 1e-4 + 1e-2 * torch.rand((C, M // chunk), generator=gen,
                                             device="cuda")
                w = torch.rand((C,), generator=gen, device="cuda")
                for qin in (q, _shifted(torch, q, 4), _shifted(torch, q, 1)):
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


# query heads over KV heads: groups 1, 2, 7 (qwen2-0.5b's) and 8, then
# whisper-base's 8 / 8 and pixtral-12b's 32 / 8 (group 4)
ATTN_HEADS = ((4, 4), (4, 2), (14, 2), (8, 1), (8, 8), (32, 8))
# whisper's cross-attention: the prompt's queries (384) and one decode
# step's (1) against its 1,500 encoder rows, non-causal at q_offset 0
CROSS_CASES = ((384, 1500), (1, 1500))


def check_flash_attention(torch):
    """The flash kernel against its plain version in f32 and bf16: groups
    1, 2, 4, 7, 8 (``ATTN_HEADS``); head_dim 32, 64, 128; causal and not;
    window None, 8, 100 and 200 (across key-tile edges); S = T = 64
    (whole tiles), S = T = 77 (ragged), S=40 inside T=131 at q_offset 91
    (ragged, S < T), S = T = 300 (five key tiles, ragged: the bf16
    kernel's ring wraps) and S=1 inside T=1000 at q_offset 999 (one query
    over 16 key tiles); then whisper's cross-attention shapes
    (``CROSS_CASES``: S = 384 and S = 1 against T = 1,500 memory rows, a
    ragged last key tile), non-causal at q_offset 0."""
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
                # whisper's cross-attention: S queries against T memory rows
                for S, T in CROSS_CASES:
                    q, k, v = _attn_inputs(torch, gen, (2, S, Hq, D),
                                           (2, T, Hkv, D), dtype)
                    got = flash_attention(q, k, v, causal=False)
                    want = attention_ref(q, k, v, causal=False)
                    torch.cuda.synchronize()
                    calls += 1
                    _hold(torch, got, want, dtype, worst, key="cross")
    # a batch past the grid's 65,535 rows: two launches
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _attn_inputs(torch, gen, (65_540, 3, 2, 32),
                               (65_540, 3, 1, 32), dtype)
        _hold(torch, flash_attention(q, k, v), attention_ref(q, k, v), dtype,
              worst)
        calls += 2
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
    print(f"flash_attention == plain version in {calls} launches, a batch "
          f"of 65,540 rows in two of them (|err| <= "
          f"{ATTN_TOL['float32']['atol']} + {ATTN_TOL['float32']['rtol']}"
          f"|plain| in f32, <= {ATTN_TOL['bfloat16']['atol']} + "
          f"{ATTN_TOL['bfloat16']['rtol']}|plain| in bf16); max |err| "
          f"{worst}; a non-contiguous q, head_dim 48, float16 and a bf16 q "
          f"off a 16-byte boundary are refused without a launch")


def check_decode_attention(torch):
    """The split-K decode kernel and its merge against the plain version,
    out and lse, in f32 and bf16: groups 1, 2, 4, 7, 8 (``ATTN_HEADS``);
    head_dim 32, 64, 128; window None, 8, 100 on caches of 64 keys (one
    split), 545 and 1000 with lengths 1, 2 (shorter than a tile), 63 and
    the whole cache; window None and 300 on a cache of 4099 keys with
    lengths 1, 64, 2049 and 4099 (splits of several tiles: the bf16
    kernel's ring wraps, and the last tile is ragged); window None on
    pixtral's serve cache of 1,569 rows (1,024 patches, a 512-token
    prompt, 32 tokens and a spare) with lengths 1, 1,025, 1,536 and
    1,568 (lengths past the patches, the prompt, the last step)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(5)
    calls, worst = 0, {}
    launches = decode_attention.launches
    merges = decode_attention.merge_launches
    caches = [(T, [1, 2, 63, T], (None, 8, 100)) for T in (64, 545, 1000)]
    caches.append((4099, [1, 64, 2049, 4099], (None, 300)))
    caches.append((PIXTRAL_CACHE, [1, 1025, 1536, PIXTRAL_CACHE - 1],
                   (None,)))
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
    # A and D a row a batch row, as the vmap rule hands them on: each
    # row equal to its own launch with its [H] A and D, bitwise
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, B, C, D = _ssd_inputs(torch, gen, 3, 2 * 64 + 13, 80, 64,
                                        1, 128, dtype, mamba_init=True,
                                        strided=True)
        A = (A[None] * torch.tensor([[0.5], [1.0], [2.0]],
                                    device="cuda")).contiguous()
        D = (D[None] + torch.arange(3, device="cuda")[:, None]).contiguous()
        y, st = ssd_scan(x, dt, A, B, C, D, chunk=64)
        _hold_ssd(torch, (y, st), ssd_ref(x, dt, A, B, C, D), dtype, worst)
        calls += 1
        for b in range(3):
            yb, sb = ssd_scan(x[b:b + 1], dt[b:b + 1], A[b], B[b:b + 1],
                              C[b:b + 1], D[b], chunk=64)
            calls += 1
            check(torch.equal(yb, y[b:b + 1]) and torch.equal(sb, st[b:b + 1]),
                  f"ssd_scan {dtype}: row {b} with its [H] A, D == its row "
                  "of the [Bt, H] call")
    # a batch past the grid's 65,535 rows: two launches
    x, dt, A, B, C, D = _ssd_inputs(torch, gen, 65_540, 3, 1, 32, 1, 16,
                                    torch.float32, mamba_init=False,
                                    strided=False)
    _hold_ssd(torch, ssd_scan(x, dt, A, B, C, D, chunk=32),
              ssd_ref(x, dt, A, B, C, D), torch.float32, worst)
    calls += 2
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
          f"|plain| for a bf16 y), per-row A and D among them (each row "
          f"== its own launch bitwise) and a batch of 65,540 rows in two "
          f"launches; max |err| {worst}; head dim 48, state 8, "
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
    ``torch.mv`` calls), the same at the population tier's C=64, and at
    M=2**22; robust_combine at path B's [20, D]
    update matrix and at M=2**22, then above 64 clients at [100, D] and
    [1024, 2**16] beside ``torch.sort`` + ``torch.mv`` only (the plain
    network is thousands of row ops a call there); dequant_aggregate at
    path C's [20, D_pad] int8 payload, at M=2**22 and at the population
    tier's [64, D_pad]. C=20 unless named, f32 (int8 codes for
    dequant_aggregate)."""
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

    # a round of path A (C=20), then of the population tier (C=64)
    for Cg in (C, POP_COHORT):
        w = torch.rand((Cg,), generator=gen, device="cuda")

        def round_tree(Cg=Cg):    # a round's stacked tree, leaves as [C, m]
            stacked = {f"{i:02d}": torch.randn((Cg,) + tuple(s),
                                               generator=gen, device="cuda")
                       for i, s in enumerate(shapes)}
            return stacked, [stacked[k].reshape(Cg, -1)
                             for k in sorted(stacked)]
        stacked, flats = round_tree()
        got = aggregate_pytree(stacked, w)
        err = max(float((got[k].reshape(-1) - weighted_aggregate_ref(x, w))
                        .abs().max()) for k, x in zip(sorted(stacked), flats))
        M = sum(x.shape[1] for x in flats)
        rows["weighted_aggregate"].append(timing_row(
            torch, "weighted_aggregate", (Cg, M), {
                "kernel": lambda tree, flats, w=w: aggregate_pytree(tree, w),
                "plain": lambda tree, flats, w=w: [
                    weighted_aggregate_ref(x, w) for x in flats],
                "library": lambda tree, flats, w=w: [
                    torch.mv(x.t(), w) for x in flats]},
            round_tree, err, (Cg + 1) * M * 4 + len(flats) * Cg * 4,
            2 * Cg * M, peaks))
    w = torch.rand((C,), generator=gen, device="cuda")
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

    # path C's payload, M=2**22, and the population tier's cohort payload
    for Cq, M in ((C, padded_dim), (C, 1 << 22), (POP_COHORT, padded_dim)):
        def codes(Cq=Cq, M=M):
            q = torch.randint(-127, 128, (Cq, M), generator=gen,
                              device="cuda", dtype=torch.int8)
            s = 1e-4 + 1e-2 * torch.rand((Cq, M // chunk), generator=gen,
                                         device="cuda")
            return q, s
        q, s = codes()
        w = torch.rand((Cq,), generator=gen, device="cuda")
        err = float((dequant_aggregate(w, s, q, chunk)
                     - dequant_aggregate_ref(w, s, q, chunk)).abs().max())
        # per code: the int8 -> f32 convert, the scale multiply and a
        # multiply-add (2)
        rows["dequant_aggregate"].append(timing_row(
            torch, "dequant_aggregate", (Cq, M), {
                "kernel": lambda q, s, w=w: dequant_aggregate(w, s, q, chunk),
                "plain": lambda q, s, w=w: dequant_aggregate_ref(w, s, q,
                                                                 chunk),
                "library": lambda q, s, w=w, Cq=Cq: torch.mv(
                    (q.float().view(Cq, -1, chunk) * s[:, :, None])
                    .view(Cq, q.shape[1]).t(), w)},
            codes, err, Cq * M + (Cq * M // chunk) * 4 + M * 4 + Cq * 4,
            4 * Cq * M, peaks))
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


def flash_row(torch, gen, peaks, B, S, T, Hq, Hkv, D, causal, iters=None):
    """One bf16 ``flash_attention`` timing row at q [B,S,Hq,D] against k, v
    [B,T,Hkv,D] (q_offset 0), beside its plain version, SDPA and its
    bound: q, k, v read once and the output written once over HBM's
    rate, against 4 * D flops a (query head, attended key) pair at the
    tensor cores' bf16 rate (a causal call attends S (S + 1) / 2 pairs a
    head, S = T)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention)

    def make():
        return _attn_inputs(torch, gen, (B, S, Hq, D), (B, T, Hkv, D),
                            torch.bfloat16)
    q, k, v = make()
    err = float((flash_attention(q, k, v, causal=causal).float()
                 - attention_ref(q, k, v, causal=causal).float())
                .abs().max())
    pairs = S * (S + 1) // 2 if causal else S * T
    return timing_row(torch, "flash_attention", (B, S, T, Hq, Hkv, D), {
        "kernel": lambda q, k, v: flash_attention(q, k, v, causal=causal),
        "plain": lambda q, k, v: attention_ref(q, k, v, causal=causal),
        "library": lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)},
        make, err, 2 * (2 * q.numel() + k.numel() + v.numel()),
        4 * D * Hq * B * pairs, (peaks[0], peaks[2]), iters=iters)


def phase_frontend_times(torch, peaks):
    """The attention kernels at the shapes phases W and V give them, in
    bf16, beside their plain versions, SDPA and their bounds (as
    ``phase_attention_times``): whisper's encoder (B=8, S=T=1,500, 8 / 8
    heads of 64, non-causal), its prefill's cross-attention (384 queries
    against the 1,500 encoder rows) and a decode step's (1 query);
    pixtral's prefill (S=T=1,536: 1,024 patches and 512 tokens, 32 / 8
    heads of 128, causal; the plain version's f32 scores are 2.4 GB a
    call, so it takes 3 calls a graph) and its decode step (a 1,569-row
    cache, lengths 1,537..1,567). Returns rows by kernel and phase."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {"flash_attention W": [
        flash_row(torch, gen, peaks, 8, S, 1500, 8, 8, 64, False)
        for S in (1500, 384, 1)]}
    rows["flash_attention V"] = [flash_row(
        torch, gen, peaks, 8, 1536, 1536, 32, 8, 128, True,
        iters={"kernel": 50, "library": 50, "plain": 3})]
    B, T, Hq, Hkv, D = 8, PIXTRAL_CACHE, 32, 8, 128

    def make():
        return _attn_inputs(torch, gen, (B, Hq, D), (B, T, Hkv, D),
                            torch.bfloat16)
    q, k, v = make()
    lengths = (1537 + torch.arange(B) * 30 // 7).to(device="cuda",
                                                    dtype=torch.int32)
    got, _ = decode_attention(q, k, v, lengths)
    err = float((got.float() - decode_attention_ref(q, k, v, lengths)[0]
                 .float()).abs().max())
    keys = int(lengths.sum())
    mask = (torch.arange(T, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    rows["decode_attention V"] = [timing_row(
        torch, "decode_attention", (B, T, Hq, Hkv, D), {
            "kernel": lambda q, k, v: decode_attention(q, k, v, lengths),
            "plain": lambda q, k, v: decode_attention_ref(q, k, v, lengths),
            "library": lambda q, k, v: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)},
        make, err,
        2 * 2 * keys * Hkv * D + 2 * 2 * q.numel() + 4 * B * Hq + 4 * B,
        4 * D * Hq * keys, (peaks[0], peaks[2]))]
    for name, found in rows.items():
        for r in found:
            print(f"{name} {r['shape']}: device {r['kernel_ms']:.5f} ms "
                  f"(eager {r['kernel_eager_ms']:.5f}), plain "
                  f"{r['plain_ms']:.5f}, sdpa {r['library_ms']:.5f}, bound "
                  f"{r['bound_ms']:.5f} ({r['bound_by']}), max |err| "
                  f"{r['max_abs_err']:.3g}")
    return rows


def ssd_work(Bt, S, H, P, G, N, chunk, itemsize, ad_rows=1):
    """(bytes, operations) of one scan: x and y, B, C (``itemsize`` bytes
    each), dt, the final state and ``ad_rows`` rows of A and D (f32)
    moved once; per (b, h, chunk) of q rows, the four products q (q + 1)
    (N + P) + 4 q P N: C B^T and its product with x over the q (q + 1) / 2
    pairs i >= j that the causal decay keeps (the mask zeroes the rest),
    C h0^T and the state update."""
    bytes_moved = (itemsize * (2 * Bt * S * H * P + 2 * Bt * S * G * N)
                   + 4 * (Bt * S * H + Bt * H * P * N + 2 * ad_rows * H))
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


def phase_fold_times(torch, peaks, lm):
    """The two LM kernels at the shapes the LM round's cross-test folds
    them to (testers x clients x eval rows into the batch), bf16, beside
    their plain versions and bounds as in ``phase_attention_times`` and
    ``phase_ssd_times``: flash at phase L's folded batch (S = T = 64,
    Hq=14, Hkv=2, D=64, causal) beside ``F.scaled_dot_product_attention``;
    ``ssd_scan`` at phase M's (S=64, H=80, P=64, G=1, N=128, chunk 256:
    one ragged chunk) with A and D a row a batch row, as the fold hands
    them on, eight clients' values over the batch; flash again at phase
    VR's folded batch (pixtral-12b's Hq=32, Hkv=8, D=128)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention)
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    hbm, bf16_peak = peaks[0], peaks[2]
    gen = torch.Generator(device="cuda").manual_seed(9)
    B, S, Hq, D = lm["L"]["folded_shape"]
    Hkv = 2

    def make_attn():
        return _attn_inputs(torch, gen, (B, S, Hq, D), (B, S, Hkv, D),
                            torch.bfloat16)
    q, k, v = make_attn()
    err = float((flash_attention(q, k, v).float()
                 - attention_ref(q, k, v).float()).abs().max())
    flash = timing_row(
        torch, "flash_attention", (B, S, S, Hq, Hkv, D), {
            "kernel": flash_attention, "plain": attention_ref,
            "library": lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)},
        make_attn, err, 2 * (2 * q.numel() + k.numel() + v.numel()),
        4 * D * Hq * B * (S * (S + 1) // 2), (hbm, bf16_peak),
        iters={"kernel": 50, "plain": 5, "library": 50})
    del q, k, v
    Bt, S, H, P = lm["M"]["folded_shape"]
    G, N, chunk, clients = 1, 128, 256, 8

    def make_ssd():
        x, dt, A, Bm, Cm, Dv = _ssd_inputs(
            torch, gen, Bt, S, H, P, G, N, torch.bfloat16, mamba_init=True,
            strided=False)
        scale = 1 + 0.05 * torch.randn((clients, 1), generator=gen,
                                       device="cuda")
        rows = torch.arange(Bt, device="cuda") * clients // Bt
        return (x, dt, (A * scale)[rows].contiguous(), Bm, Cm,
                (Dv * scale)[rows].contiguous())
    args = make_ssd()
    y, st = ssd_scan(*args, chunk=chunk)
    yr, sr = ssd_ref(*args)
    err = max(float((y.float() - yr.float()).abs().max()),
              float((st - sr).abs().max()))
    del args, y, st, yr, sr
    ssd = timing_row(
        torch, "ssd_scan", (Bt, S, H, P, G, N), {
            "kernel": lambda *a: ssd_scan(*a, chunk=chunk), "plain": ssd_ref},
        make_ssd, err, *ssd_work(Bt, S, H, P, G, N, chunk, 2, ad_rows=Bt),
        (hbm, bf16_peak), iters={"kernel": 20, "plain": 1})
    # phase VR's fold: pixtral-12b's heads (32 / 8 of 128), the mma.sync
    # instance
    B, S, Hq, D = lm["VR"]["folded_shape"]
    vlm = flash_row(torch, gen, peaks, B, S, S, Hq, VLM_KV_HEADS, D, True,
                    iters={"kernel": 50, "plain": 5, "library": 50})
    for r in (flash, vlm, ssd):
        print(f"{r['name']} folded {r['shape']}: device {r['kernel_ms']:.5f}"
              f" ms (eager {r['kernel_eager_ms']:.5f}), plain "
              f"{r['plain_ms']:.3f}, library "
              f"{r.get('library_ms', float('nan')):.5f}, bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}), max |err| "
              f"{r['max_abs_err']:.3g}")
    return {"flash_attention_fold": [flash], "ssd_scan_fold": [ssd],
            "flash_attention_fold V": [vlm]}


def phase_path(torch, path, argv, op_name, rounds):
    """``rounds`` full-width rounds of one path through the launcher's
    code path. Every kernel's launch count is set to 0 just before the
    rounds and read just after: ``op_name`` must have launched and no
    other. Returns (launches of op_name, round wall ms, the adversary's
    malicious weights, (trainer, data)), the trainer for phase R to
    rebuild without this phase's step timers."""
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate_ref
    from repro_torch.kernels.robust_combine import (
        robust_combine_network_ref, row_select_weights)
    from repro_torch.kernels.weighted_aggregate import (
        plan_launches, weighted_aggregate_ref)
    from repro_torch.launch.train import build, parse_args
    from repro_torch.utils import tree_leaves

    if "--population" in argv:
        # B100 leaves the allocator's cache full
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, data, cfg = build(parse_args(argv))
    state = trainer.init()
    program = trainer.program
    n_params = trainer.model.param_count(state.global_params)
    population = trainer.fed.cohort > 0
    print(f"path {path}: {cfg.name} ({n_params:,} params), "
          f"{trainer.fed.num_users} users, {trainer.fed.num_testers} "
          f"testers, malicious "
          f"{_ids(trainer.attack.malicious_indices(trainer.fed.num_users))}, "
          f"aggregator {trainer.fed.aggregator}, compressor "
          f"{trainer.fed.compressor}"
          + (f", cohort {trainer.capacity} (participation "
             f"{trainer.fed.participation:.6f}, testers from the cohort "
             f"{trainer.testers_from_cohort})" if population else "")
          + f"; set-up {time.perf_counter() - t0:.1f} s")
    check(n_params == FULL_WIDTH_PARAMS[cfg.name],
          f"{cfg.name} has {n_params} params")

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
    if program.aggregator.needs_server_eval:
        # time the closure the round calls, not the binding of it
        server_eval = backend.server_eval
        backend.server_eval = lambda *a: timed("server_eval",
                                               server_eval(*a))
    if trainer.eval_resample_every > 0:
        trainer.eval_batches = timed("eval_batches", trainer.eval_batches)
    fed = trainer.fed
    adversary = (program.use_faults or program.coalition_active
                 or fed.lying_testers > 0)
    if adversary or population:
        # keep each round's draws, to name the clients its faults dropped
        # and its cohort
        draw = trainer.draw

        def keep_draws(*args):
            seen["draws"] = draw(*args)
            return seen["draws"]
        trainer.draw = keep_draws
    if adversary:
        print(f"path {path}: coalition {fed.coalition} members "
              f"{program.coalition.members(fed.num_users)}, fault "
              f"{fed.fault}, lying testers {fed.lying_testers}, "
              f"aggregator_kwargs {dict(fed.aggregator_kwargs)}")

    kernel_ops = ops()
    torch.cuda.synchronize()
    reset_counts(kernel_ops)
    walls, adversary_rows = [], []
    for _ in range(rounds):
        step_ms.clear()
        before = state.scores.scores
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
        ids = seen["cross_test"][0][4].tolist()
        if population:
            # testers recruited from the cohort (the reference's remap,
            # id mod the cohort's size) need not be distinct
            cohort = seen["draws"].cohort.ids
            bad = program.attack.malicious_set(fed.num_users)
            (_, _, models, *_), attacked = seen["attack"]
            check_cohort_round(torch, path, trainer, seen["draws"], before,
                               metrics, slot_unchanged(torch, models,
                                                       attacked))
            check(len(ids) == fed.num_testers and set(ids) <= set(cohort),
                  f"path {path}: {fed.num_testers} tester ids from the "
                  f"cohort, got {ids}")
            print(f"path {path} round {state.round_idx}: wall "
                  f"{walls[-1]:.1f} ms  local_loss {values[0]:.4f}  "
                  f"malicious_weight {values[1]:.5f}  global_acc "
                  f"{acc:.4f}  cohort {len(cohort)} clients, "
                  f"{sum(c in bad for c in cohort)} malicious, testers "
                  f"{ids}")
            adversary_rows.append(values[1])
            continue
        check(len(set(ids)) == trainer.fed.num_testers
              and all(0 <= i < trainer.fed.num_users for i in ids),
              f"path {path}: {trainer.fed.num_testers} distinct tester "
              f"ids, got {ids}")
        print(f"path {path} round {state.round_idx}: wall "
              f"{walls[-1]:.1f} ms  local_loss {values[0]:.4f}  "
              f"malicious_weight {values[1]:.5f}  global_acc {acc:.4f}  "
              f"weights [{' '.join(f'{v:.4f}' for v in w.tolist())}]")
        if adversary:
            adversary_rows.append(check_adversary_round(
                torch, path, program, seen["draws"], state.round_idx - 1,
                before, metrics, ids))
    counts = {name: op.launches for name, op in kernel_ops.items()}
    # path A: the grouped kernel's launches for the tree (one a table of
    # TABLE leaves: 1 for fedtest-cnn's 10); B and C: one a round
    leaf_sizes = [p.numel() for p in tree_leaves(state.global_params)]
    per_round = (len(plan_launches(leaf_sizes, [True] * len(leaf_sizes), 4))
                 if op_name == "weighted_aggregate" else 1)
    want = {name: (per_round * rounds if name == op_name else 0)
            for name in kernel_ops}
    check(counts == want
          and kernel_ops["decode_attention"].merge_launches == 0,
          f"path {path} launches {counts}, want {want}")
    print(f"path {path} launches: {counts} ({per_round} {op_name} a round "
          f"x {rounds} rounds)")

    # the last round's step-7 output against the plain version on its
    # own inputs
    if op_name == "weighted_aggregate":
        (models, weights, _), out = seen["aggregate"]
        models, weights = cohort_operands(models, weights)
        pairs = [(got.reshape(-1), weighted_aggregate_ref(
            stack.reshape(stack.shape[0], -1), weights))
            for got, stack in zip(tree_leaves(out), tree_leaves(models))]
        tol = dict(rtol=1e-5, atol=1e-6)
    elif op_name == "robust_combine":
        (ctx, updates), out = seen["combine"]
        check(tuple(updates.shape) == (trainer.fed.num_users, n_params),
              f"path {path} combines a {tuple(updates.shape)} matrix")
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
    return counts[op_name], walls, adversary_rows, (trainer, data)


def graph_launches(torch, fn, names):
    """Kernel launches of ``fn`` by name, from a ``torch.profiler`` trace
    (CUPTI sees the kernels of a graph replay, which no wrapper counts):
    ``{name: launches}`` for each kernel whose demangled name holds one of
    ``names``, the trace's summed device ms and its kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts, device_ms, launches = collections.Counter(), 0.0, 0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0):
            continue
        device_ms += e.self_device_time_total / 1e3
        launches += e.count
        for name in names:
            if name in e.key:
                counts[name] += e.count
    return counts, device_ms, launches


def phase_rounds_per_call(torch, card, path, built, op_name):
    """Phase R on one path, from ``built``, the ``(trainer, data)`` its
    ``phase_path`` ran (a trainer built anew from its fields, without that
    phase's step timers): ``RPC`` + 1 eager rounds from the seed (the
    second under ``torch.cuda.set_sync_debug_mode("error")``: a round
    after the first, as a capture follows its warm-up round, so a host
    read left in the round fails here before a capture does), then the
    same rounds through a trainer with ``rounds_per_call`` = ``RPC``: one
    chunk, ``RPC`` replays of the graph it captures, and an eager
    remainder (on ``RPC_REUSE``, ``2 * RPC`` + 1 rounds: a second chunk
    on the same buffers and graph). The end states must be bitwise equal
    (every param, the score fields, the generator's state and the error
    feedback). Then, on the captured graph: ``RPC`` replays back to back,
    each between CUDA events (the device's time of a round) and all on
    the host clock (the graphed time of a round), and one replay
    profiled, which must launch ``op_name``'s kernel once (the tree's
    grouped launches for weighted_aggregate), though no wrapper counts a
    replay. Returns the numbers printed."""
    import dataclasses
    from repro_torch.kernels.weighted_aggregate import plan_launches
    from repro_torch.utils import tree_leaves

    trainer, data = built
    eager = dataclasses.replace(trainer)
    graphed = dataclasses.replace(trainer, rounds_per_call=RPC)
    chunks = 2 if path == RPC_REUSE else 1
    rounds = chunks * RPC + 1

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    state, eager_ms, eager_metrics = eager.init(), [], []
    for r in range(rounds):
        if r == 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            (state, metrics), ms = timed(lambda: eager.run_round(state,
                                                                 data))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eager_ms.append(ms)
        eager_metrics.append(metrics)
    sizes = [p.numel() for p in tree_leaves(state.global_params)]
    per_round = (len(plan_launches(sizes, [True] * len(sizes), 4))
                 if op_name == "weighted_aggregate" else 1)
    kernel_ops = ops()
    reset_counts(kernel_ops)
    g_state, chunk_ms = graphed.init(), []
    for _ in range(chunks):
        (g_state, stacked), ms = timed(lambda: graphed.run_chunk(g_state,
                                                                 data))
        chunk_ms.append(ms)
    host_launches = kernel_ops[op_name].launches
    check(host_launches == 2 * per_round,
          f"path {path}: the wrapper counted {host_launches} launches over "
          f"{chunks} chunk(s), want {2 * per_round} (the warm-up round's "
          f"and the capture's; a replay calls no wrapper)")
    g_state, _ = graphed.run_round(g_state, data)
    torch.cuda.synchronize()
    check(graphed.chunk is not None and graphed.chunk.graph is not None,
          f"path {path}: one CUDA graph captured")
    n = _bitwise(torch, state, g_state,
                 f"path {path}: {rounds} rounds as {chunks} chunk(s) of "
                 f"{RPC} replays and one eager round against {rounds} "
                 f"eager rounds")
    check(bool(torch.isfinite(stacked["weights"]).all())
          and stacked["weights"].shape == (RPC, eager.fed.num_users),
          f"path {path}: a chunk's weights finite and stacked [R, N]")
    if eager.fed.cohort:
        # the population tier: the history too, each replay's metrics
        # against its eager round's
        first = (chunks - 1) * RPC
        differ = sorted({k for k, v in stacked.items() for i in range(RPC)
                         if not torch.equal(_bits(torch, v[i]), _bits(
                             torch, eager_metrics[first + i][k]))})
        check(not differ, f"path {path}: the chunk's {RPC} rounds of "
              f"metrics bitwise the eager rounds' (differ: {differ})")

    # RPC replays back to back: CUDA events around each (the device's
    # time of a round), the host clock around them all (graphed)
    graph = graphed.chunk.graph
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(RPC)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    graphed_round = (time.perf_counter() - t) * 1e3 / RPC
    device_ms = [start.elapsed_time(end) for start, end in events]
    counts, trace_ms, trace_launches = graph_launches(
        torch, graph.replay, list(GRAPH_KERNELS.values()))
    want = {GRAPH_KERNELS[op_name]: per_round}
    check(dict(counts) == want,
          f"path {path}: a replay launches {dict(counts)} by the profiler, "
          f"want {want}")
    steady = eager_ms[1:]
    eager_round = sum(steady) / len(steady)
    device_round = sum(device_ms) / len(device_ms)
    out = {"rounds": rounds, "rounds_per_call": RPC,
           "tensors_bitwise": n, "eager_ms": eager_ms,
           "first_chunk_ms": chunk_ms[0], "chunk_ms": chunk_ms[1:],
           "eager_round_ms": eager_round, "graphed_round_ms": graphed_round,
           "device_round_ms": device_ms, "device_round_mean_ms":
           device_round, "idle_eager": 1 - device_round / eager_round,
           "idle_graphed": 1 - device_round / graphed_round,
           "replay_launches": dict(counts),
           "replay_trace_launches": trace_launches,
           "replay_trace_device_ms": trace_ms,
           "wrapper_launches_capture": host_launches,
           "phase_s": time.perf_counter() - t0, "card": card}
    reuse = (f"; a second chunk {chunk_ms[1] / RPC:.3f} ms a round"
             if chunks > 1 else "")
    print(f"phase R path {path} ({op_name}): {rounds} rounds, {chunks} "
          f"chunk(s) of {RPC} replays + 1 eager, bitwise the eager run "
          f"({n} tensors); a round: eager {eager_round:.3f} ms, graphed "
          f"{graphed_round:.3f} ms, device {device_round:.3f} ms (idle "
          f"{out['idle_eager']:.3f} eager, {out['idle_graphed']:.3f} "
          f"graphed){reuse}; first chunk (warm-up + capture + {RPC} "
          f"replays) {chunk_ms[0]:.1f} ms; a replay launches "
          f"{dict(counts)} of {trace_launches} kernels ({trace_ms:.3f} ms "
          f"by the profiler), the wrapper counted {host_launches} (the "
          f"warm-up and the capture); phase {out['phase_s']:.1f} s; {card}")
    return out


def phase_rpc_seams(torch, card):
    """Phase R's seams, the round's readers of its index or of a value
    the host makes (``SEAMS``: ``round_robin``, ``coverage``'s cycles,
    ``fixed``'s ids, the ``targeted`` fault's start, dropout with int8,
    trust and eval rows redrawn every 2 rounds, the lying testers under
    ``score_weighted``), each on ``fedtest-mlp-mnist`` with one hidden
    layer of 32, 6 users and 2 testers: ``SEAM_ROUNDS`` eager rounds from
    the seed against ``FederatedTrainer.run`` at ``rounds_per_call`` =
    ``RPC``, one trainer to ``SEAM_SPLIT`` rounds with a checkpoint, a
    second restoring it and running on (two chunks of the graph it
    captures, so its buffers, the coverage schedule and the eval rows are
    loaded again for the second): bitwise equal. Returns each case's
    seconds."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import FedConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import MNIST_LIKE, make_federated_image_dataset
    from repro_torch.models import build_model

    model = build_model(get_config("fedtest-mlp-mnist").replace(
        mlp_hidden=(32,)))
    data = make_federated_image_dataset(MNIST_LIKE, 6, num_samples=1200,
                                        global_test=100, seed=0,
                                        device="cuda")
    tc = TrainConfig(optimizer="sgd", lr=0.1, schedule="constant",
                     batch_size=8, grad_clip=0.0)
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seams_") as scratch:
        for name, fed_kw in SEAMS.items():
            fed = FedConfig(num_users=6, num_testers=2, num_malicious=1,
                            attack="random_weights", local_steps=2,
                            **fed_kw)

            def trainer(rounds_per_call):
                return FederatedTrainer(
                    model, fed, tc, eval_batch=32, device="cuda",
                    rounds_per_call=rounds_per_call,
                    eval_resample_every=SEAM_RESAMPLE.get(name, 0))

            t0 = time.perf_counter()
            eager = trainer(1)
            want = eager.init()
            for _ in range(SEAM_ROUNDS):
                want, _ = eager.run_round(want, data)
            mgr = CheckpointManager(os.path.join(scratch, name),
                                    save_every=SEAM_SPLIT)
            first = trainer(RPC)
            first.run(data, rounds=SEAM_SPLIT, ckpt=mgr)
            second = trainer(RPC)
            state, at = second.restore_checkpoint(mgr)
            got, hist = second.run(data, rounds=SEAM_ROUNDS, state=state)
            _bitwise(torch, want, got,
                     f"phase R seam {name}: {SEAM_SPLIT} rounds, a "
                     f"checkpoint and {SEAM_ROUNDS - SEAM_SPLIT} resumed, "
                     f"in chunks of {RPC} replays, against {SEAM_ROUNDS} "
                     f"eager rounds")
            check(at == SEAM_SPLIT and hist["round"] == [8, 12]
                  and all(t.chunk.graph is not None
                          for t in (first, second)),
                  f"phase R seam {name}: resumed at {at}, history "
                  f"{hist['round']}, a graph on each trainer")
            seconds[name] = time.perf_counter() - t0
    print(f"phase R seams: {len(seconds)} bitwise through a resume, "
          f"chunks of {RPC} replays ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
          + f"); {card}")
    return seconds


def lm_chunk(torch, card, label, trainer, data, want, eager_ms,
             eager_peak):
    """Phase L's chunk: ``RPC_LM`` rounds through a trainer built anew
    from ``trainer``'s fields with ``rounds_per_call`` = ``RPC_LM`` (one
    capture, ``RPC_LM`` replays), from the seed, against ``want``, the
    host copy of the phase's state after its first ``RPC_LM`` eager
    rounds: bitwise. The cache is emptied before the warm-up round, and
    the graph keeps its own pool beside the phase's data; the allocator's
    peak is printed beside the eager rounds'. The train CLI runs such a
    chunk (it refuses ``--rounds-per-call`` > 1 only with
    ``--population``), so running out of memory here fails the smoke.
    Returns the numbers printed."""
    import dataclasses

    graphed = dataclasses.replace(trainer, rounds_per_call=RPC_LM)
    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g_state, _ = graphed.run_chunk(graphed.init(), data)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    got = {k: t.cpu() for k, t in _state_tensors(g_state).items()}
    differ = [k for k in want if not torch.equal(_bits(torch, want[k]),
                                                 _bits(torch, got[k]))]
    check(want.keys() == got.keys() and not differ,
          f"phase {label} chunk: {RPC_LM} replays bitwise {RPC_LM} eager "
          f"rounds ({len(want)} tensors; differ: {differ})")
    device_ms = _events(torch, graphed.chunk.graph.replay, 1)
    eager_round = sum(eager_ms) / len(eager_ms)
    out = {"rounds_per_call": RPC_LM, "tensors_bitwise": len(want),
           "eager_round_ms": eager_round, "first_chunk_ms": chunk_ms,
           "device_round_ms": device_ms,
           "idle_eager": 1 - device_ms / eager_round,
           "eager_peak_bytes": eager_peak, "peak_bytes": peak, "card": card}
    print(f"phase {label} chunk: {RPC_LM} replays bitwise {RPC_LM} eager "
          f"rounds ({len(want)} tensors); eager round {eager_round:.1f} ms "
          f"(its first rounds), first chunk (warm-up + capture + "
          f"{RPC_LM} replays) {chunk_ms:.1f} ms, a replay {device_ms:.1f} "
          f"ms on the device; peak {peak / 2**30:.3f} GiB against the eager "
          f"rounds' {eager_peak / 2**30:.3f} GiB; {card}")
    del graphed, g_state
    free_memory(torch)
    return out


def lm_fold_check(torch, label, op_name, captured, testers, clients, rows):
    """The first layer's folded launch of the last cross-test, held
    against the K x N launches of its (tester, client) blocks, each
    ``rows`` batch rows (every (batch row, head) is computed alone, so
    they must be equal bitwise), and against the plain version within
    ``ATTN_TOL`` / ``SSD_TOL``. For ``ssd_scan`` each block takes its
    client's own ``[H]`` A and D (the folded launch read them a row a
    batch row), and the clients' A must differ."""
    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention)
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    args, out = captured
    blocks = testers * clients
    check(args[0].shape[0] == blocks * rows,
          f"phase {label}: the folded batch is {args[0].shape[0]} rows, "
          f"want {testers} x {clients} x {rows}")
    with torch.no_grad():
        if op_name == "flash_attention":
            q, k, v, causal, window, scale, q_offset = args
            kw = dict(causal=causal, sliding_window=window or None,
                      scale=scale, q_offset=q_offset)
            parts = [flash_attention(q[sl], k[sl], v[sl], **kw)
                     for sl in (slice(i * rows, (i + 1) * rows)
                                for i in range(blocks))]
            check(torch.equal(torch.cat(parts), out),
                  f"phase {label}: the folded flash launch == its "
                  f"{blocks} block launches bitwise")
            want = attention_ref(q, k, v, **kw)
            torch.testing.assert_close(out.float(), want.float(),
                                       **ATTN_TOL["bfloat16"])
            err = float((out.float() - want.float()).abs().max())
            shape = (tuple(q.shape), tuple(k.shape))
        else:
            x, dt, A, B, C, D, chunk = args
            y, st = out
            check(A.shape == (x.shape[0], x.shape[2]) == D.shape,
                  f"phase {label}: A and D a row a folded batch row, got "
                  f"{tuple(A.shape)}, {tuple(D.shape)}")
            check(not torch.equal(A[0], A[rows]),
                  f"phase {label}: the clients' A differ after training")
            ys, sts = [], []
            for i in range(blocks):
                sl = slice(i * rows, (i + 1) * rows)
                check(bool((A[sl] == A[sl][0]).all())
                      and bool((D[sl] == D[sl][0]).all()),
                      f"phase {label}: one client's A and D a block")
                yb, sb = ssd_scan(x[sl], dt[sl], A[sl][0], B[sl], C[sl],
                                  D[sl][0], chunk=chunk)
                ys.append(yb)
                sts.append(sb)
            check(torch.equal(torch.cat(ys), y)
                  and torch.equal(torch.cat(sts), st),
                  f"phase {label}: the folded ssd_scan launch (per-row A, "
                  f"D) == its {blocks} block launches ([H] A, D) bitwise")
            yr, sr = ssd_ref(x, dt, A, B, C, D)
            _hold_ssd(torch, (y, st), (yr, sr), x.dtype, {})
            err = max(float((y.float() - yr.float()).abs().max()),
                      float((st - sr).abs().max()))
            shape = (tuple(x.shape), tuple(A.shape))
    print(f"phase {label}: the first layer's folded {op_name} launch "
          f"{shape} == its {blocks} (tester, client) launches bitwise and "
          f"the plain version (max |err| {err:.3g})")
    return err


# the caching allocator's counters a round of phase_lm prints: a retry
# frees every cached block and synchronises the card before it allocates
ALLOC_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def phase_lm(torch, card, label, argv, op_name, overrides=None,
             reduced_why=None, chunk=False, rounds=LM_ROUNDS,
             frozen_leaf=None):
    """The LM federated round through the train launcher's code path
    (``build(parse_args(argv), **overrides)``, the overrides cutting the
    depth):
    ``LM_ROUNDS`` rounds, each followed by the global accuracy. Every
    kernel's count is set to 0 just before the rounds; read around each
    step: local training launches nothing, a cross-test launches
    ``op_name`` once a layer (the vmap rule folds K x N x rows into one
    launch), so does the global eval, and step 7 launches
    ``weighted_aggregate`` once a table (2 a round: the bf16 leaves and
    the f32 ones); no other kernel runs. The last cross-test's first
    folded launch is captured and checked (:func:`lm_fold_check`).
    ``reduced_why`` replaces the ``reduced`` line's reckoning. With
    ``chunk``, the state after the first ``RPC_LM`` rounds is kept on the
    host and :func:`lm_chunk` runs them again as one chunk of replays.
    On the population tier (``--population``, phase LP) a cross-test
    launches twice a layer (the cohort's K x C x rows fold, then the
    global model's column, K x rows) and each round is held as path G's
    (:func:`check_cohort_round`). ``frozen_leaf`` names a leaf no
    gradient reaches (the vlm's ``patch_proj`` on its text): under SGD
    every client's trained copy must equal the global one bitwise.
    Returns the numbers printed."""
    import repro_torch.kernels.flash_attention.ops as flash_ops
    import repro_torch.kernels.ssd_scan.ops as ssd_ops
    from repro_torch.configs import get_config
    from repro_torch.kernels.weighted_aggregate.ops import TABLE
    from repro_torch.launch.train import build, parse_args
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves

    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = parse_args(argv)
    trainer, data, cfg = build(args, **(overrides or {}))
    state = trainer.init()
    torch.cuda.synchronize()
    fed, model = trainer.fed, trainer.model
    population = fed.cohort > 0
    clients = trainer.capacity if population else fed.num_users
    # the population tier's provider wraps the dense dataset
    dense = data.dense if population else data
    n_params = model.param_count(state.global_params)
    full = get_config(args.arch)
    check(n_params == model.param_count() and cfg.d_model == full.d_model
          and cfg.vocab_size == full.vocab_size,
          f"phase {label}: {cfg.name} at its published widths "
          f"({n_params} params)")
    if overrides:
        full_params = build_model(full).param_count()
        why = reduced_why or (
            f"{fed.num_users} clients at 2 + 2 + 8 bytes a param (bf16 "
            f"weights and gradients, AdamW's two f32 moments) take "
            f"{full_params * fed.num_users * 12 / 1e9:.0f} GB at full "
            f"depth, over the card's 80 GB")
        print(f"reduced: phase {label} runs {cfg.name} with {cfg.num_layers} "
              f"of its {full.num_layers} layers ({n_params:,} of "
              f"{full_params:,} params, widths unchanged): {why}")
    print(f"phase {label}: {cfg.name} ({n_params:,} params, {cfg.num_layers}"
          f" layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), {fed.num_users} users"
          + (f" (a cohort of {clients} a round, testers from it "
             f"{trainer.testers_from_cohort})" if population else "")
          + f", {fed.num_testers} testers, malicious "
          f"{_ids(trainer.attack.malicious_indices(fed.num_users))}"
          f" ({fed.attack}), {fed.local_steps} steps of batch "
          f"{trainer.train.batch_size}, {trainer.train.optimizer} at lr "
          f"{trainer.train.lr}; train {tuple(dense.train.xs.shape)}, eval "
          f"rows {min(trainer.eval_batch, dense.test.xs.shape[1])} a tester, "
          f"global {tuple(data.global_x.shape)}; set-up "
          f"{time.perf_counter() - t0:.1f} s")

    kernel_ops = ops()
    step_ms, deltas = {}, {}

    def counted(step, fn):
        def run(*a):
            torch.cuda.synchronize()
            before = {n: op.launches for n, op in kernel_ops.items()}
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            step_ms[step] = (time.perf_counter() - t) * 1e3
            deltas[step] = {n: op.launches - before[n]
                            for n, op in kernel_ops.items()}
            return out
        return run

    backend = trainer.backend
    for step, method in (("train", "train"), ("cross_test", "cross_test"),
                         ("aggregate", "weighted_sum")):
        setattr(backend, method, counted(step, getattr(backend, method)))
    global_eval = counted("global_eval", trainer.global_accuracy)
    frozen = []
    if frozen_leaf is not None:
        train = backend.train

        def train_frozen(local_train, global_params, bx, by):
            models, losses = train(local_train, global_params, bx, by)
            g, stack = global_params[frozen_leaf], models[frozen_leaf]
            frozen.append(all(torch.equal(_bits(torch, stack[c]),
                                          _bits(torch, g))
                              for c in range(stack.shape[0])))
            return models, losses
        backend.train = train_frozen
    seen = {}
    if population:
        # each round's draws and its attack's slots (a flag a slot, so no
        # cohort stack outlives the round)
        draw, apply_attack = trainer.draw, backend.apply_attack

        def keep_draws(*a, **k):
            seen["draws"] = draw(*a, **k)
            return seen["draws"]

        def witness(attack, noise, models, *rest):
            out = apply_attack(attack, noise, models, *rest)
            seen["unchanged"] = slot_unchanged(torch, models, out)
            return out
        trainer.draw, backend.apply_attack = keep_draws, witness

    # the last round's cross-test: keep the first folded launch's inputs
    # and output (the first layer's)
    module = flash_ops if op_name == "flash_attention" else ssd_ops
    launch, captured, armed = module._launch, [], [False]

    def capturing(*a):
        out = launch(*a)
        if armed[0] and not captured:
            captured.append((a, out))
        return out
    cross_test, testers = backend.cross_test, []

    def arming(*a):
        testers.append(a[4].tolist())
        armed[0] = len(walls) == rounds - 1
        try:
            return cross_test(*a)
        finally:
            armed[0] = False
    backend.cross_test = arming

    # step 7: one grouped launch a table of up to TABLE leaves of a dtype
    # (the bf16 weights, the f32 norm scales and Mamba2 dt_bias, A_log, D)
    by_dtype = collections.Counter(
        p.dtype for p in tree_leaves(state.global_params))
    aggregates = sum(-(-n // TABLE) for n in by_dtype.values())
    per_test = cfg.num_layers * (2 if population else 1)
    want_step = {"train": {}, "cross_test": {op_name: per_test},
                 "global_eval": {op_name: cfg.num_layers},
                 "aggregate": {"weighted_aggregate": aggregates}}
    walls, rows = [], []
    torch.cuda.synchronize()
    reset_counts(kernel_ops)
    module._launch = capturing
    try:
        for _ in range(rounds):
            step_ms.clear()
            entering = state.scores.scores
            before = torch.cuda.memory_stats()
            t = time.perf_counter()
            state, metrics = trainer.run_round(state, data)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            after = torch.cuda.memory_stats()
            churn = [after.get(k, 0) - before.get(k, 0) for k in ALLOC_KEYS]
            acc = global_eval(state, data)
            rest = walls[-1] - sum(v for k, v in step_ms.items()
                                   if k != "global_eval")
            w = metrics["weights"]
            values = [float(metrics["local_loss"]),
                      float(metrics["malicious_weight"]), acc]
            check(all(math.isfinite(v) for v in values),
                  f"phase {label}: finite loss, malicious weight, accuracy "
                  f"{values}")
            check(bool(torch.isfinite(w).all())
                  and abs(float(w.sum()) - 1.0) < 1e-5,
                  f"phase {label}: finite weights summing to 1: {w}")
            check(all(bool(torch.isfinite(p).all())
                      for p in tree_leaves(state.global_params)),
                  f"phase {label}: finite global params")
            if population:
                cohort = seen["draws"].cohort.ids
                corrupted = check_cohort_round(
                    torch, f"phase {label}", trainer, seen["draws"],
                    entering, metrics, seen["unchanged"])
                check(len(testers[-1]) == fed.num_testers
                      and set(testers[-1]) <= set(cohort),
                      f"phase {label}: {fed.num_testers} testers from the "
                      f"cohort {cohort}, got {testers[-1]}")
                print(f"phase {label} round {state.round_idx}: cohort "
                      f"{list(cohort)}, {corrupted} slot(s) corrupted")
            else:
                check(len(set(testers[-1])) == fed.num_testers
                      and all(0 <= i < fed.num_users for i in testers[-1]),
                      f"phase {label}: {fed.num_testers} distinct testers, "
                      f"got {testers[-1]}")
            if frozen_leaf is not None:
                check(frozen[-1], f"phase {label}: every client's trained "
                      f"{frozen_leaf} equals the global one bitwise (no "
                      f"gradient reaches it; {trainer.train.optimizer})")
            for step, want in want_step.items():
                got = {n: c for n, c in deltas[step].items() if c}
                check(got == want, f"phase {label} round "
                      f"{state.round_idx}: {step} launched {got}, want "
                      f"{want}")
            rows.append(values[1])
            if chunk and state.round_idx == RPC_LM:
                chunk_want = {k: t.cpu()
                              for k, t in _state_tensors(state).items()}
            print(f"phase {label} round {state.round_idx}: wall "
                  f"{walls[-1]:.1f} ms (" + ", ".join(
                      f"{k} {v:.2f}" for k, v in step_ms.items())
                  + f", rest {rest:.2f})  local_loss {values[0]:.4f}  "
                  f"malicious_weight {values[1]:.5f}  global token acc "
                  f"{acc:.4f}  testers {testers[-1]}  weights "
                  f"[{' '.join(f'{v:.4f}' for v in w.tolist())}]  "
                  f"allocator: retries {churn[0]}, cudaMalloc {churn[1]}, "
                  f"cudaFree {churn[2]}, reserved "
                  f"{after['reserved_bytes.all.current'] / 2**30:.3f} GiB")
    finally:
        module._launch = launch
    counts = {n: op.launches for n, op in kernel_ops.items()}
    want = {n: 0 for n in kernel_ops}
    want[op_name] = (per_test + cfg.num_layers) * rounds
    want["weighted_aggregate"] = aggregates * rounds
    check(counts == want
          and kernel_ops["decode_attention"].merge_launches == 0,
          f"phase {label} launches {counts}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase {label} launches: {counts} ({per_test} {op_name} a "
          f"cross-test, {cfg.num_layers} a global eval, {aggregates} "
          f"weighted_aggregate a round "
          f"({dict((str(k), v) for k, v in by_dtype.items())} leaves), x "
          f"{rounds} rounds; none in local training); allocator peak "
          f"{peak / 2**30:.3f} GiB; {card}")
    check(len(captured) == 1, f"phase {label}: the folded launch captured")
    rows_per = min(trainer.eval_batch, dense.test.xs.shape[1])
    err = lm_fold_check(torch, label, op_name, captured[0], fed.num_testers,
                        clients, rows_per)
    folded = tuple(captured[0][0][0].shape)
    del captured
    out = {"wall_ms": walls, "malicious_weight": rows,
           "launches": counts[op_name],
           "weighted_aggregate_launches": counts["weighted_aggregate"],
           "peak_bytes": peak,
           "params": n_params, "layers": cfg.num_layers,
           "folded_shape": folded, "fold_max_abs_err": err}
    if cfg.has_moe:
        # the global model's loss on 16 global sequences, with the MoE
        # load-balance loss it adds (the capacity route, as in training)
        with torch.no_grad():
            loss, m = model.loss(state.global_params,
                                 {"tokens": data.global_x[:16],
                                  "labels": data.global_y[:16]})
        out.update(loss=float(loss), nll=float(m["nll"]),
                   moe_aux=float(m["moe_aux"]))
        check(all(math.isfinite(out[k]) for k in ("loss", "nll", "moe_aux")),
              f"phase {label}: finite loss and moe_aux")
        print(f"phase {label}: the global model's loss {out['loss']:.5f} = "
              f"nll {out['nll']:.5f} + {cfg.router_aux_coef} x moe_aux "
              f"{out['moe_aux']:.5f} (summed over {cfg.num_layers} MoE "
              f"layers; 1.0 a layer is balanced)")
    if chunk:
        del state, metrics
        out["chunk"] = lm_chunk(torch, card, label, trainer, data,
                                chunk_want, walls[:RPC_LM], peak)
    return out


def _ids(ids, show=12):
    """A client id set for a log line: whole when short, else its size
    and ends."""
    ids = list(ids)
    if len(ids) <= show:
        return ids
    return f"{len(ids)} ids {ids[:3]}...{ids[-3:]}"


def cohort_operands(models, weights):
    """Step 7's operands as the kernel gets them: the population tier's
    ``[C]`` stack and its weights gathered to the slots (0 on an
    unfilled one); the dense stack and weights as they are."""
    from repro_torch.core.engine import CohortModels
    if not isinstance(models, CohortModels):
        return models, weights
    return models.stack, slot_weights(models.plan, weights)


def slot_weights(plan, weights):
    """The ``[N]`` weights gathered to a cohort plan's slots, 0 on an
    unfilled one."""
    n = weights.shape[0]
    return weights[plan.idx.clamp(max=n - 1)] * plan.valid


def slot_unchanged(torch, models, attacked):
    """Whether each slot of a population round's cohort stack came out of
    step 3 bitwise as it went in (``models`` and ``attacked`` are its
    ``CohortModels`` before and after the attack): a list of host
    bools."""
    from repro_torch.utils import tree_leaves
    pairs = list(zip(tree_leaves(models.stack), tree_leaves(attacked.stack)))
    return [all(torch.equal(_bits(torch, a[s]), _bits(torch, b[s]))
                for a, b in pairs)
            for s in range(pairs[0][0].shape[0])]


def check_cohort_round(torch, label, trainer, draws, before, metrics,
                       unchanged):
    """A population round against its draws: at most C filled slots;
    every filled slot of an honest client leaves the attack bitwise its
    trained model and every filled slot of a malicious one differs from
    it (``unchanged``: :func:`slot_unchanged` of the round's step 3); the
    weights finite, summing to 1 and exactly 0 outside the honoured
    cohort, and the scores outside it bitwise as they entered. Returns
    the number of slots the attack corrupted."""
    n, cap = trainer.fed.num_users, trainer.capacity
    cohort = draws.cohort.ids
    check(len(cohort) <= cap and list(cohort) == sorted(set(cohort)),
          f"{label}: {len(cohort)} filled slots of {cap}")
    bad = trainer.program.attack.malicious_set(n)
    want = [c not in bad for c in cohort]
    check(unchanged[:len(cohort)] == want,
          f"{label}: slots left bitwise by the attack "
          f"{unchanged[:len(cohort)]}, want the honest members' {want} "
          f"(cohort {_ids(cohort)})")
    w, scores = metrics["weights"], metrics["scores"]
    inside = torch.zeros((n,), dtype=torch.bool, device=w.device)
    inside[list(cohort)] = True
    check(bool(torch.isfinite(w).all())
          and abs(float(w.sum()) - 1.0) < 1e-5,
          f"{label}: finite weights summing to 1, got {float(w.sum())}")
    check(bool((w[~inside] == 0).all()),
          f"{label}: weight outside the cohort "
          f"{float(w[~inside].abs().sum())}")
    check(torch.equal(scores[~inside], before[~inside]),
          f"{label}: the scores outside the cohort are unchanged")
    return want.count(False)


def check_adversary_round(torch, path, program, draws, round_idx, before,
                          metrics, tester_ids):
    """A round of path E or F against its draws: the clients its faults
    dropped (the composed mask, recomputed from the round's draws) are
    paid exactly 0 and keep the score they entered with, and
    ``dropped_fraction`` is their share. Returns the round's numbers."""
    from repro_torch.core.engine import compose_fault_mask
    fed = program.fed
    part = draws.part_mask
    kept = part
    if program.use_faults:
        kept = compose_fault_mask(part, program.fault.mask(
            draws.fault_draws, fed.num_users, round_idx, device=part.device))
    out = kept == 0
    w, scores = metrics["weights"], metrics["scores"]
    dropped = float(metrics["dropped_fraction"])
    want = float((part.sum() - kept.sum()) / torch.clamp(part.sum(), min=1))
    check(bool((w[out] == 0).all()),
          f"path {path}: dropped clients are paid 0, got {w[out].tolist()}")
    check(torch.equal(scores[out], before[out]),
          f"path {path}: dropped clients keep their scores")
    check(dropped == want, f"path {path}: dropped_fraction {dropped} is "
          f"the dropped share {want}")
    members = program.coalition.members(fed.num_users)
    row = {"round": round_idx + 1,
           "dropped": out.nonzero().flatten().tolist(),
           "dropped_fraction": dropped,
           "coalition_weight": float(w[list(members)].sum())
           if members else 0.0,
           "malicious_weight": float(metrics["malicious_weight"]),
           "liar_testers": [i for i in tester_ids
                            if i < fed.lying_testers]}
    print(f"path {path} round {row['round']}: dropped {row['dropped']} "
          f"(dropped_fraction {dropped:.4f}), coalition weight "
          f"{row['coalition_weight']:.5f}, malicious weight "
          f"{row['malicious_weight']:.5f}, lying testers on the committee "
          f"{row['liar_testers']}")
    return row


def ci_population(device: str, seed: int = 0):
    """(trainer, data) of the reference CI's ``population-smoke`` job as
    ``repro.launch.federated``'s population path builds it, less its
    cohort sharding over 4 devices: ``fedtest-cnn-mnist`` cut to channels
    (8, 16, 16) and a hidden width of 32, a synthetic MNIST-like
    population (``make_synthetic_population``, 64 rows a client drawn on
    gather), eval batches of 64 and the CI_* settings, on ``device``."""
    from repro_torch.config import FedConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.engine import PopulationTrainer
    from repro_torch.data import MNIST_LIKE, make_synthetic_population
    from repro_torch.models import build_model

    n, c = CI_POPULATION, CI_COHORT
    fed = FedConfig(num_users=n, cohort=c, participation=c / n,
                    num_testers=CI_TESTERS, num_malicious=CI_MALICIOUS,
                    attack="sign_flip", aggregator="fedtest",
                    selector="rotating", local_steps=CI_STEPS,
                    rounds=CI_ROUNDS, seed=seed)
    cfg = get_config("fedtest-cnn-mnist").replace(cnn_channels=(8, 16, 16),
                                                  cnn_hidden=32)
    tc = TrainConfig(optimizer="sgd", lr=CI_LR, schedule="constant",
                     batch_size=CI_BATCH, grad_clip=0.0)
    data = make_synthetic_population(
        n, per_client=max(CI_BATCH * 4, 64),
        image_size=MNIST_LIKE.image_size, channels=MNIST_LIKE.channels,
        num_classes=MNIST_LIKE.num_classes, noise=MNIST_LIKE.noise,
        seed=seed, device=device)
    trainer = PopulationTrainer(build_model(cfg), fed, tc, eval_batch=64,
                                device=device, testers_from_cohort=True)
    return trainer, data


def phase_population_ci(torch, card):
    """The reference CI's ``population-smoke`` job (``ci_population``)
    through ``PopulationTrainer.run``. The launch counts, set to 0 before
    the run, must show one ``weighted_aggregate`` a round and no other
    kernel; every value must be finite, and the mean malicious weight
    over the rounds below the attackers' share of the population. The
    CI's gate on the last round is printed beside it. Then the same
    rounds from the same init as chunks of CI_RPC replays of one CUDA
    graph: the state and every round's malicious weight bitwise the
    eager run's. Then the same job with its slots trained in the groups
    of CI_RANKS ranks (``train_block``), the run P3 holds the pod CLI's
    sharded one to. Returns the phase's numbers."""
    import dataclasses
    from repro_torch.kernels.weighted_aggregate import plan_launches
    from repro_torch.utils import tree_leaves

    n, c = CI_POPULATION, CI_COHORT
    trainer, data = ci_population("cuda")
    kernel_ops = ops()
    torch.cuda.synchronize()
    reset_counts(kernel_ops)
    t0 = time.perf_counter()
    state, hist = trainer.run(data)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = {name: op.launches for name, op in kernel_ops.items()}
    sizes = [p.numel() for p in tree_leaves(state.global_params)]
    per_round = len(plan_launches(sizes, [True] * len(sizes), 4))
    want = {name: (per_round * CI_ROUNDS if name == "weighted_aggregate"
                   else 0) for name in kernel_ops}
    check(counts == want
          and kernel_ops["decode_attention"].merge_launches == 0,
          f"CI population-smoke launches {counts}, want {want}")
    mal = [float(v) for v in hist["malicious_weight"]]
    acc = [float(v) for v in hist["global_accuracy"]]
    check(all(math.isfinite(v) for v in mal + acc)
          and all(bool(torch.isfinite(p).all())
                  for p in tree_leaves(state.global_params)),
          "CI population-smoke: finite malicious weights, accuracies and "
          "params")
    n_params = trainer.model.param_count(state.global_params)
    print(f"CI population-smoke ({n_params:,} params, {n:,} clients, "
          f"cohort {c}): malicious weight a round "
          f"{[round(v, 5) for v in mal]}, global accuracy "
          f"{[round(v, 4) for v in acc]}; {CI_ROUNDS} rounds in {wall:.1f}"
          f" ms; {card}")
    share, mean = CI_MALICIOUS / n, sum(mal) / len(mal)
    held = mal[-1] < CI_GATE
    print(f"CI population-smoke: mean malicious weight {mean:.5f} against "
          f"the attackers' share {share:.5f}; the CI's gate (the last "
          f"round below {CI_GATE}) {'held' if held else 'missed'}")
    check(mean < share,
          f"CI population-smoke: mean malicious weight {mean:.5f} is not "
          f"below the attackers' share {share:.5f}")
    # the same rounds as chunks of CI_RPC replays of one CUDA graph
    chunked = dataclasses.replace(trainer, rounds_per_call=CI_RPC)
    g_state, g_mal = chunked.init(), []
    reset_counts(kernel_ops)
    t0 = time.perf_counter()
    for _ in range(CI_ROUNDS // CI_RPC):
        g_state, stacked = chunked.run_chunk(g_state, data)
        g_mal += [float(v) for v in stacked["malicious_weight"]]
    torch.cuda.synchronize()
    chunk_wall = (time.perf_counter() - t0) * 1e3
    chunk_launches = kernel_ops["weighted_aggregate"].launches
    check(chunk_launches == 2 * per_round,
          f"CI population-smoke chunks: the wrapper counted "
          f"{chunk_launches}, want {2 * per_round} (the warm-up's and the "
          f"capture's)")
    check(g_mal == mal, f"CI population-smoke: the malicious weights of "
          f"{CI_ROUNDS // CI_RPC} chunks of {CI_RPC} {g_mal} equal the "
          f"eager run's bitwise")
    tensors = _bitwise(torch, state, g_state,
                       f"CI population-smoke: {CI_ROUNDS // CI_RPC} chunks "
                       f"of {CI_RPC} against {CI_ROUNDS} eager rounds")
    print(f"CI population-smoke: {CI_ROUNDS // CI_RPC} chunks of {CI_RPC} "
          f"graph replays bitwise the eager run ({tensors} tensors, every "
          f"round's malicious weight) in {chunk_wall:.1f} ms, the capture "
          f"included; {card}")
    # P3's reference: the same job with its slots trained in the groups
    # the pod CLI's CI_RANKS ranks train them in (a vmap's width changes
    # how the card rounds a slot's training)
    grouped = dataclasses.replace(trainer, train_block=c // CI_RANKS)
    reset_counts(kernel_ops)
    _, ghist = grouped.run(data)
    grouped_launches = kernel_ops["weighted_aggregate"].launches
    check(grouped_launches == per_round * CI_ROUNDS,
          f"CI population-smoke in groups: {grouped_launches} launches, "
          f"want {per_round * CI_ROUNDS}")
    grouped_mal = [float(v) for v in ghist["malicious_weight"]]
    parted = next((r + 1 for r, (a, b) in enumerate(zip(mal, grouped_mal))
                   if a != b), None)
    print(f"CI population-smoke with its slots trained in groups of "
          f"{c // CI_RANKS}: malicious weight a round "
          f"{[round(v, 5) for v in grouped_mal]}; the one-group run's "
          f"series {'parts from it at round ' + str(parted) if parted else 'equals it bitwise'}; "
          f"{card}")
    return {"clients": n, "cohort": c, "malicious_weight": mal,
            "global_acc": acc, "mean_malicious_weight": mean,
            "attackers_share": share, "ci_gate": CI_GATE,
            "ci_gate_held": held, "wall_ms": wall,
            "chunked_wall_ms": chunk_wall,
            "grouped_malicious_weight": grouped_mal,
            "grouped_parts_at_round": parted,
            "launches": (counts["weighted_aggregate"] + chunk_launches
                         + grouped_launches)}


# ------------------------------------------------------------ phase P
def pod_rank(group, runs):
    """One rank of phase P1 (spawned by ``run_ranks``): each of ``runs``,
    ``(label, FedConfig fields, exchange, rounds)``, through
    :class:`PodTrainer` (the pod CLI's driver) on ``fedtest-cnn`` at full
    width from the seed. The launch counts, the exchange's tracing
    counters and the allocator's peak are set to 0 before a run's rounds
    and read after; the last round's step-7 output is held against the plain
    version on its own inputs. Returns, for each run, numpy copies of
    what the parent compares."""
    import torch
    from repro_torch import tracing
    from repro_torch.config import FedConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.engine import PodTrainer
    from repro_torch.data import CIFAR_LIKE, make_federated_image_dataset
    from repro_torch.kernels.robust_combine import (
        robust_combine_network_ref, row_select_weights)
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate_ref
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves

    dev, rank, n = group.device, group.rank, group.world_size
    model = build_model(get_config("fedtest-cnn"))
    data = make_federated_image_dataset(CIFAR_LIKE, n,
                                        num_samples=POD_SAMPLES * n // POD_N,
                                        seed=0, device=dev)
    kernel_ops = ops()
    out = {}
    for label, fed_kw, exchange, rounds in runs:
        trainer = PodTrainer(model, FedConfig(**fed_kw),
                             TrainConfig(**POD_TRAIN), eval_batch=POD_EVAL,
                             group=group, exchange=exchange)
        program, backend, seen = trainer.program, trainer.backend, {}

        def keep(step, fn):
            def run(*args):
                seen[step] = (args, fn(*args))
                return seen[step][1]
            return run
        backend.cross_test = keep("cross_test", backend.cross_test)
        backend._stack = keep("stack", backend._stack)
        backend.weighted_sum = keep("aggregate", backend.weighted_sum)
        if program.uses_combine:
            program.aggregator.combine = keep("combine",
                                              program.aggregator.combine)
        state = trainer.init(0)
        torch.cuda.synchronize(dev)
        reset_counts(kernel_ops)
        # the exchange's spans and counters (pod.exchange,
        # pod.exchange.calls, pod.bytes_staged), read a round at a time
        tracing.export()
        tracing.enable()
        torch.cuda.reset_peak_memory_stats(dev)
        walls, exchange, rows, first = [], [], [], None
        staged = calls = 0
        for r in range(rounds):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, metrics = trainer.run_round(state, data)
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            traced = tracing.export()
            exchange.append(sum(s["host_ms"] for s in traced["spans"]
                                if s["name"] == "pod.exchange"))
            staged += traced["counters"].get("pod.bytes_staged", 0)
            calls += traced["counters"].get("pod.exchange.calls", 0)
            if r == 0 and rank == 0 and "stack" in seen:
                first = [t.cpu().numpy()
                         for t in tree_leaves(seen["stack"][1])]
            rows.append({
                "weights": metrics["weights"].cpu().numpy(),
                "malicious_weight": float(metrics["malicious_weight"]),
                "counts": (seen["cross_test"][1] * POD_EVAL).round()
                .to(torch.int64).cpu().numpy()})
        tracing.enable(False)
        launches = {k: op.launches for k, op in kernel_ops.items()}
        # the last round's step 7 against the plain version
        if program.uses_combine:
            (ctx, updates), got = seen["combine"]
            agg = program.aggregator
            mask = agg.gate_mask(ctx)
            w_row = row_select_weights(mask, mode=agg._mode,
                                       trim_fraction=agg.trim_fraction)
            pairs = [(got, robust_combine_network_ref(updates, mask, w_row))]
            shape = tuple(updates.shape)
        else:
            (_, weights, _), got = seen["aggregate"]
            stack = seen["stack"][1]
            pairs = [(g.reshape(-1), weighted_aggregate_ref(
                x.reshape(x.shape[0], -1), weights))
                for g, x in zip(tree_leaves(got), tree_leaves(stack))]
            shape = tuple(tree_leaves(stack)[0].shape[:1])
        err = max(float((a - b).abs().max()) for a, b in pairs)
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        out[label] = dict(
            walls=walls, rows=rows, launches=launches, err=err,
            shape=shape, exchange_ms=exchange,
            bytes_staged=staged, calls=calls,
            peak=torch.cuda.max_memory_allocated(dev),
            params=[p.cpu().numpy()
                    for p in tree_leaves(state.global_params)],
            first=first, gen=state.gen.get_state().numpy(),
            transport=group.transport)
    return out


def pod_local_trainer():
    """P1's run on the local backend on the card: the trainer and the
    dataset (POD_N clients, the ranks' data)."""
    from repro_torch.config import FedConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FederatedTrainer
    from repro_torch.data import CIFAR_LIKE, make_federated_image_dataset
    from repro_torch.models import build_model
    trainer = FederatedTrainer(
        build_model(get_config("fedtest-cnn")), FedConfig(**POD_FED),
        TrainConfig(**POD_TRAIN), eval_batch=POD_EVAL, device="cuda")
    data = make_federated_image_dataset(CIFAR_LIKE, POD_N,
                                        num_samples=POD_SAMPLES, seed=0,
                                        device=trainer.device)
    return trainer, data


def pod_local(torch, rounds, per_client=False):
    """The local backend's rounds of P1's first run from the same seed
    (its draws are the pod's): per round the weights and the [K, N]
    counts, then the final params and the round-1 model stack. With
    ``per_client`` its local phase trains one client at a time, as a pod
    rank does (``local_train`` on one client's batches), in place of the
    vmap over the clients' stack."""
    from repro_torch.utils import tree_leaves, tree_map

    trainer, data = pod_local_trainer()
    backend, accs, models = trainer.backend, [], []
    cross_test = backend.cross_test

    def keep(*args):
        accs.append(cross_test(*args))
        models.append(args[1])
        return accs[-1]
    backend.cross_test = keep
    if per_client:
        def train(local_train, global_params, bx, by):
            out = [local_train(global_params, bx[c], by[c])
                   for c in range(bx.shape[0])]
            return (tree_map(lambda *leaves: torch.stack(leaves),
                             *[params for params, _ in out]),
                    torch.stack([loss for _, loss in out]))
        backend.train = train
    state, rows = trainer.init(0), []
    for _ in range(rounds):
        state, metrics = trainer.run_round(state, data)
        rows.append({"weights": metrics["weights"].cpu().numpy(),
                     "counts": (accs[-1] * POD_EVAL).round()
                     .to(torch.int64).cpu().numpy()})
    return (rows,
            [p.cpu().numpy() for p in tree_leaves(state.global_params)],
            [t.cpu().numpy() for t in tree_leaves(models[0])])


def _preacts(torch, params, images):
    """The pre-activations of each ReLU of ``fedtest-cnn``'s forward on
    ``images``, op for op ``repro_torch.models.cnn.CNN.forward``: each
    conv layer's output (NCHW), then fc1's."""
    import torch.nn.functional as F
    x = images.permute(0, 3, 1, 2)
    out = []
    for i in range(len(params) - 2):
        layer = params[f"conv{i}"]
        out.append(F.conv2d(x, layer["w"].permute(3, 2, 0, 1), layer["b"],
                            padding=1))
        x = F.max_pool2d(F.relu(out[-1]), 2, ceil_mode=True)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    out.append(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return out


def _route_masks(torch, zs):
    """Where the backward lets a gradient through, from ``_preacts``: a
    conv pre-activation that is positive and is its 2x2 max-pool window's
    winner (the pool's own indices), an fc1 pre-activation that is
    positive. Any leading batch axes."""
    import torch.nn.functional as F
    masks = []
    for z in zs[:-1]:
        flat = z.reshape((-1,) + z.shape[-3:])
        _, idx = F.max_pool2d(F.relu(flat), 2, ceil_mode=True,
                              return_indices=True)
        won = torch.zeros(flat.shape[:2] + (flat[0, 0].numel(),),
                          dtype=torch.bool, device=z.device)
        won.scatter_(2, idx.flatten(2), True)
        masks.append((won.view_as(flat) & (flat > 0)).view_as(z))
    masks.append(zs[-1] > 0)
    return masks


def _flip_record(torch, flip, z_vmapped, z_alone):
    """The first element whose gradient route differs (``flip``, flat):
    its pre-activation in both runs and, in each, its signed distance to
    the kink that decides the route: the ReLU's 0, or for a conv element
    positive in both runs, its 2x2 max-pool window's winner."""
    import numpy as np
    import torch.nn.functional as F
    i = int(flip.nonzero()[0])
    zs = {"vmapped": z_vmapped, "alone": z_alone}
    out = {"flips": int(flip.sum())}
    for key, z in zs.items():
        out[f"z_{key}"] = float(z.flatten()[i])
    relu = ((out["z_vmapped"] > 0) != (out["z_alone"] > 0)
            or z_alone.dim() < 4)
    out["kink"] = "ReLU" if relu else "max-pool tie"
    for key, z in zs.items():
        if relu:
            out[f"margin_{key}"] = out[f"z_{key}"]
            continue
        b, ch, h, w = np.unravel_index(i, tuple(z.shape))
        pooled = F.max_pool2d(F.relu(z[b:b + 1]), 2, ceil_mode=True)
        out[f"margin_{key}"] = (out[f"z_{key}"]
                                - float(pooled[0, ch, h // 2, w // 2]))
    return out


def vmap_witness(torch):
    """Where the local backend's vmapped local phase parts from the same
    clients trained one at a time (P1 prints both runs): round 1's
    batches of P1's run, each SGD step taken both ways from the step's
    own params, in float32 through ``RoundProgram.local_train`` and in
    float64 (the model's forward under ``torch.func.grad``, cross-entropy
    and SGD in f64). Per client and step it compares the two forwards'
    pre-activations (their spread: a layer's max |difference|) and
    gradient routes (``_route_masks``), and records the first step that
    routes a gradient otherwise: the element, its pre-activation in both
    runs and its distance to the kink. Held: the f32 vmapped steps are
    bitwise ``LocalBackend.train``'s round; the first forward, from the
    same params, spreads by at most VMAP_FORWARD_RTOL of each layer's
    largest pre-activation; before a client's first flip its params
    agree within VMAP_ROUNDING; in f64 no route flips and the params end
    within VMAP_F64_ATOL. Returns the numbers."""
    import torch.nn.functional as F
    from torch.func import grad, vmap

    from repro_torch.utils import tree_leaves, tree_map

    trainer, data = pod_local_trainer()
    program, n, lr = trainer.program, POD_N, POD_TRAIN["lr"]
    model = program.train_model
    state = trainer.init(0)
    bx, by, _, _ = trainer.client_batches(data, trainer.draw(state, data))
    g = state.global_params
    want, _ = trainer.backend.train(program.local_train, g, bx, by)
    layers = [f"conv{i}" for i in range(len(g) - 2)] + ["fc1"]
    steps = bx.shape[1]

    def step32(p, x, y):
        return program.local_train(p, x[None], y[None])[0]

    def step64(p, x, y):
        def loss(q):
            return F.cross_entropy(model.forward_train(q, {"images": x}),
                                   y.long())
        return tree_map(lambda a, d: a - lr * d, p, grad(loss)(p))

    out = {}
    for dtype, step in ((torch.float32, step32), (torch.float64, step64)):
        key = "f32" if dtype == torch.float32 else "f64"
        start = tree_map(lambda t: t.to(dtype), g)
        xs = bx.to(dtype)
        stack = tree_map(lambda t: t[None].expand((n,) + t.shape), start)
        own, first, diffs, rounding = [start] * n, [None] * n, [], []
        forward = [None] * n     # the first forward's spread / scale
        for s in range(steps):
            zv = vmap(lambda p, x: _preacts(torch, p, x))(stack, xs[:, s])
            mv = _route_masks(torch, zv)
            for c in range(n):
                if first[c] is not None:
                    continue
                zc = _preacts(torch, own[c], xs[c, s])
                spread = [float((v[c] - w).abs().max()) for v, w in
                          zip(zv, zc)]
                if s == 0:
                    forward[c] = [d / float(w.abs().max())
                                  for d, w in zip(spread, zc)]
                for name, a, b, v, w, d in zip(
                        layers, mv, _route_masks(torch, zc), zv, zc, spread):
                    flip = (a[c] != b).flatten()
                    if flip.any():
                        first[c] = dict(_flip_record(torch, flip, v[c], w),
                                        step=s, layer=name, spread=d)
                        break
            stack = vmap(step)(stack, xs[:, s], by[:, s])
            own = [step(own[c], xs[c, s], by[c, s]) for c in range(n)]
            pairs = [list(zip((t[c] for t in tree_leaves(stack)),
                              tree_leaves(own[c]))) for c in range(n)]
            diffs.append([max(float((a - b).abs().max()) for a, b in pc)
                          for pc in pairs])
            rounding.append([all(torch.allclose(a, b, **VMAP_ROUNDING)
                                 for a, b in pc) for pc in pairs])
        out[key] = {"first_flip": first, "max_diff_by_step": diffs,
                    "first_forward_spread": forward}
        for c in range(n):
            flip = first[c]
            print(f"P1 vmap witness {key} client {c}: the first forward's "
                  f"spread / scale {[f'{r:.3g}' for r in forward[c]]} "
                  f"({', '.join(layers)}); "
                  + ("no gradient route flips" if flip is None else
                     f"first route flip at step {flip['step'] + 1} of "
                     f"{steps} in {flip['layer']} ({flip['flips']} "
                     f"elements, at a {flip['kink']}), pre-activation "
                     f"{flip['z_vmapped']:.6g} vmapped, "
                     f"{flip['z_alone']:.6g} alone, from the kink "
                     f"{flip['margin_vmapped']:.3g} and "
                     f"{flip['margin_alone']:.3g}, the layer's spread "
                     f"{flip['spread']:.3g}")
                  + f"; params max |diff| after each step "
                  f"{[f'{d[c]:.3g}' for d in diffs]}")
            check(max(forward[c]) <= VMAP_FORWARD_RTOL,
                  f"vmap witness {key} client {c}: the first forward's "
                  f"spread within {VMAP_FORWARD_RTOL} of each layer's scale")
            before = steps if flip is None else flip["step"]
            check(all(r[c] for r in rounding[:before]),
                  f"vmap witness {key} client {c}: params within "
                  f"{VMAP_ROUNDING} before the first route flip")
        if dtype == torch.float32:
            check(_same([t.cpu().numpy() for t in tree_leaves(stack)],
                        [t.cpu().numpy() for t in tree_leaves(want)]),
                  "vmap witness: the step-by-step vmapped run is bitwise "
                  "LocalBackend.train's")
        else:
            check(first == [None] * n and max(diffs[-1]) <= VMAP_F64_ATOL,
                  f"vmap witness f64: no route flips ({first}) and the "
                  f"params end within {VMAP_F64_ATOL} "
                  f"({max(diffs[-1]):.3g})")
    return out


def _same(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))


def phase_pod(torch, card):
    """P1: the pod round at full width on POD_N ranks sharing the card
    (gloo, staged through host memory), ring and allgather POD_ROUNDS
    rounds each: ring == allgather bitwise (params, weights, [K, N]
    counts, generator); against the local backend on the same draws with
    its clients trained one at a time, as the ranks train them, the
    counts, the weights and the params bitwise; the local backend's own
    vmapped run beside it, printed, and ``vmap_witness`` on where it
    parts; ``weighted_aggregate`` once a round on every rank and no other
    kernel. The same group then runs the reference crosstest schedule on
    both exchanges (bitwise the batched runs), the mutual_boost coalition
    for POD_MB_ROUNDS rounds, and one ring round of
    ``trimmed_mean_coord``: ``robust_combine`` once on every rank, on the
    gathered [POD_N, 188,810] matrix. Returns the phase's numbers, with
    every run's launches summed over the ranks."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import scenario_for_pod
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    boost = dataclasses.asdict(dataclasses.replace(
        scenario_for_pod("mutual_boost_vs_fedtest", POD_N),
        local_steps=POD_FED["local_steps"], seed=0))
    reference = dict(POD_FED, crosstest_impl="reference")
    runs = [("ring", POD_FED, "ring", POD_ROUNDS),
            ("allgather", POD_FED, "allgather", POD_ROUNDS),
            ("ring reference", reference, "ring", POD_ROUNDS),
            ("allgather reference", reference, "allgather", POD_ROUNDS),
            ("mutual_boost", boost, "ring", POD_MB_ROUNDS),
            ("trimmed_mean_coord", dict(POD_FED, **POD_COMBINE), "ring", 1)]
    t0 = time.perf_counter()
    ranks = run_ranks(pod_rank, POD_N, runs, device_type="cuda",
                      backend="gloo", timeout_s=300, join_timeout_s=600)
    group_s = time.perf_counter() - t0
    # the local backend twice: training one client at a time, as a rank
    # does (held bitwise), and under its vmap over the clients (printed;
    # vmap_witness shows where and why the two part)
    local = {mode: pod_local(torch, POD_ROUNDS,
                             per_client=mode == "per client")
             for mode in ("per client", "vmapped")}
    out = {"group_s": group_s, "transport": ranks[0]["ring"]["transport"],
           "vmap_witness": vmap_witness(torch)}
    ring, gather = ranks[0]["ring"], ranks[0]["allgather"]
    check(_same(ring["params"], gather["params"])
          and np.array_equal(ring["gen"], gather["gen"])
          and all(_same([a["weights"], a["counts"]],
                        [b["weights"], b["counts"]])
                  for a, b in zip(ring["rows"], gather["rows"])),
          "P1: ring == allgather bitwise (params, weights, counts, "
          "generator)")
    for rank, res in enumerate(ranks):
        check(_same(res["ring"]["params"], ring["params"]),
              f"P1: rank {rank} holds rank 0's params")
    for label in ("ring", "allgather"):
        one, two = ranks[0][label], ranks[0][f"{label} reference"]
        check(_same(one["params"], two["params"])
              and np.array_equal(one["gen"], two["gen"])
              and all(_same([a["weights"], a["counts"]],
                            [b["weights"], b["counts"]])
                      for a, b in zip(one["rows"], two["rows"])),
              f"P1 {label}: crosstest batched == reference bitwise")
    print("P1 crosstest: batched == reference bitwise on ring and "
          "allgather (params, weights, counts, generator)")
    boost_rows = [per["mutual_boost"] for per in ranks]
    for rank, r in enumerate(boost_rows):
        want = {k: (POD_MB_ROUNDS if k == "weighted_aggregate" else 0)
                for k in r["launches"]}
        check(r["launches"] == want, f"P1 mutual_boost rank {rank} "
              f"launches {r['launches']}, want {want}")
    mal = [r["malicious_weight"] for r in boost_rows[0]["rows"]]
    check(all(math.isfinite(v) for v in mal)
          and all(np.isfinite(p).all() for p in boost_rows[0]["params"]),
          f"P1 mutual_boost: finite malicious weights {mal} and params")
    print(f"P1 mutual_boost ({POD_MB_ROUNDS} rounds, ring): malicious "
          f"weight a round {[round(v, 5) for v in mal]}, final "
          f"{mal[-1]:.5f} against the CI's bar 0.1 "
          f"({'below' if mal[-1] < 0.1 else 'not below'}); round ms "
          f"{[round(t, 3) for t in boost_rows[0]['walls']]}")
    for mode, (rows, params, first) in local.items():
        by_client = [max(float(np.abs(a[c] - b[c]).max())
                         for a, b in zip(ring["first"], first))
                     for c in range(POD_N)]
        print(f"P1 against the local backend ({mode}): round 1's models, "
              f"each client's params max |diff| "
              f"{[f'{d:.3g}' for d in by_client]}")
        for r, (a, b) in enumerate(zip(ring["rows"], rows)):
            differ = a["counts"] != b["counts"]
            print(f"P1 ({mode}) round {r + 1}: {int(differ.sum())} of "
                  f"{differ.size} counts differ (by at most "
                  f"{int(np.abs(a['counts'] - b['counts']).max())} of "
                  f"{POD_EVAL}); weights equal "
                  f"{bool(np.array_equal(a['weights'], b['weights']))}")
        diff = max(float(np.abs(a - b).max())
                   for a, b in zip(ring["params"], params))
        print(f"P1 ({mode}): the final params max |diff| {diff:.3g}")
        out[f"local {mode}"] = {"round1_client_max_diff": by_client,
                                "params_max_diff": diff}
    rows, params, _ = local["per client"]
    for label in ("ring", "allgather"):
        res = ranks[0][label]
        check(all(np.array_equal(a["counts"], b["counts"])
                  and np.array_equal(a["weights"], b["weights"])
                  for a, b in zip(res["rows"], rows))
              and _same(res["params"], params),
              f"P1 {label}: counts, weights and params bitwise the local "
              "backend's (one client trained at a time)")
        for rank, per in enumerate(ranks):
            r = per[label]
            want = {k: (POD_ROUNDS if k == "weighted_aggregate" else 0)
                    for k in r["launches"]}
            check(r["launches"] == want,
                  f"P1 {label} rank {rank} launches {r['launches']}, "
                  f"want {want}")
        # the exchange's share of the steady rounds (the first pays the
        # set-up of cuDNN, the kernels and gloo's connections)
        walls = [per[label]["walls"] for per in ranks]
        share = [sum(per[label]["exchange_ms"][1:]) / sum(w[1:])
                 for per, w in zip(ranks, walls)]
        staged = [per[label]["bytes_staged"] / POD_ROUNDS for per in ranks]
        peaks = [per[label]["peak"] / 2**20 for per in ranks]
        print(f"P1 {label} ({res['transport']}): round ms rank 0 "
              f"{[round(t, 3) for t in walls[0]]}, every rank's steady "
              f"mean {[round(sum(w[1:]) / len(w[1:]), 3) for w in walls]}; "
              f"rank 0's exchange ms a round "
              f"{[round(t, 3) for t in res['exchange_ms']]}, every rank's "
              f"steady share {[round(x, 3) for x in share]}; bytes staged "
              f"a round {[int(b) for b in staged]}; collectives a round "
              f"{ranks[0][label]['calls'] / POD_ROUNDS:.0f}; peak MiB "
              f"{[round(p, 1) for p in peaks]}; weighted_aggregate once a "
              f"round on every rank on a {res['shape']} stack (max |err| "
              f"against the plain version {res['err']:.3g}); {card}")
        out[label] = {"round_ms": walls, "exchange_share": share,
                      "exchange_ms": [per[label]["exchange_ms"]
                                      for per in ranks],
                      "bytes_staged_a_round": staged, "peak_mib": peaks,
                      "malicious_weight": [r["malicious_weight"]
                                           for r in res["rows"]],
                      "launches": sum(per[label]["launches"][
                          "weighted_aggregate"] for per in ranks)}
    comb = [per["trimmed_mean_coord"] for per in ranks]
    for rank, r in enumerate(comb):
        want = {k: (1 if k == "robust_combine" else 0) for k in r["launches"]}
        check(r["launches"] == want and r["shape"] == (POD_N, 188_810),
              f"P1 combine rank {rank}: launches {r['launches']} on "
              f"{r['shape']}, want {want} on ({POD_N}, 188810)")
    print(f"P1 trimmed_mean_coord (ring): robust_combine once on every "
          f"rank on the gathered {comb[0]['shape']} matrix (max |err| "
          f"against the plain version {comb[0]['err']:.3g}); round ms "
          f"{[round(r['walls'][0], 3) for r in comb]}; {card}")
    out["trimmed_mean_coord"] = {"round_ms": [r["walls"][0] for r in comb],
                                 "launches": len(comb)}
    out["mutual_boost"] = {"malicious_weight": mal,
                           "launches": POD_MB_ROUNDS * len(boost_rows)}
    out["launches"] = {op: sum(per[label]["launches"][op]
                               for per in ranks for label in per)
                       for op in ranks[0]["ring"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def pod_nccl(card):
    """P1's round at world size 1 under nccl (one card a rank is nccl's
    layout; a four-card run waits for a four-chip cell): its collectives
    must run and ``weighted_aggregate`` launch once. Returns its numbers
    and launch counts."""
    from repro_torch.launch.mesh import run_ranks
    one = dict(POD_FED, num_users=1, num_testers=1, num_malicious=0,
               attack="none")
    t0 = time.perf_counter()
    nccl = run_ranks(pod_rank, 1, [("nccl", one, "ring", 1)],
                     device_type="cuda", backend="nccl", timeout_s=300,
                     join_timeout_s=300)[0]["nccl"]
    want = {k: (1 if k == "weighted_aggregate" else 0)
            for k in nccl["launches"]}
    check(nccl["transport"] == "nccl" and nccl["calls"] > 0
          and nccl["launches"] == want,
          f"P1 nccl at world size 1: transport {nccl['transport']}, "
          f"{nccl['calls']} collectives, launches {nccl['launches']}")
    print(f"P1 nccl, world size 1: {nccl['calls']} collectives on the card "
          f"in a round of {nccl['walls'][0]:.3f} ms "
          f"({nccl['exchange_ms'][0]:.3f} ms in them), weighted_aggregate "
          f"once; the group took "
          f"{time.perf_counter() - t0:.1f} s. A four-card nccl run (one "
          f"client a card) waits for a four-chip cell; {card}")
    return {"round_ms": nccl["walls"], "calls": nccl["calls"],
            "exchange_ms": nccl["exchange_ms"],
            "launches": nccl["launches"],
            "group_s": time.perf_counter() - t0}


def phase_pod_cli(torch, card, ci_malicious):
    """P2 and P3: the reference CI's pod-smoke and population-smoke
    commands (POD_CLI) through ``python -m repro_torch.launch.federated
    --dist-backend gloo``, all at once, each a group of 4 ranks sharing
    the card, and meanwhile P1's round at world size 1 under nccl
    (``pod_nccl``). Each must exit 0 with finite values and rank 0's
    kernel a round and no other; the population run's malicious weight a
    round must equal, bitwise, the unsharded ``PopulationTrainer`` run of
    the same flags and seed with its slots trained in the ranks' groups
    (``ci_malicious``, from ``phase_population_ci``). Each final
    malicious weight is printed beside the CI's bar of 0.1."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    scratch = tempfile.mkdtemp(prefix="chip_smoke_pod_")
    t0 = time.perf_counter()
    try:
        procs = {}
        for name, argv, _, _ in POD_CLI:
            cmd = [sys.executable, "-m", "repro_torch.launch.federated",
                   "--device", "cuda", "--dist-backend", "gloo", "--out",
                   os.path.join(scratch, name)] + argv
            # a session of its own: a failed run's ranks go with it
            procs[name] = (time.perf_counter(), subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, start_new_session=True))
        done = {}
        try:
            nccl = pod_nccl(card)
            for name, (start, proc) in procs.items():
                stdout, _ = proc.communicate(timeout=900)
                done[name] = (proc.returncode, stdout,
                              time.perf_counter() - start)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=60)
        out = {}
        for name, argv, rounds, op_name in POD_CLI:
            rc, stdout, wall = done[name]
            check(rc == 0, f"P2 {name}: exit {rc}\n{stdout[-3000:]}")
            lines = stdout.splitlines()
            head = next(ln for ln in lines
                        if ln.startswith(("pod:", "population:")))
            launches = json.loads(next(
                ln for ln in lines if ln.startswith("rank 0 kernel launches")
            ).split(": ", 1)[1])
            want = {k: (rounds if k == op_name else 0) for k in launches}
            check(launches == want, f"P2 {name}: rank 0 launches "
                  f"{launches}, want {want}")
            kind = "population" if name == "population" else (
                "allgather" if "allgather" in argv else "ring")
            with open(os.path.join(scratch, name,
                                   f"mnist_like__{kind}.json")) as f:
                hist = json.load(f)
            mal = hist["malicious_weight"]
            check(len(mal) == rounds and all(math.isfinite(v) for v in mal),
                  f"P2 {name}: {rounds} finite malicious weights {mal}")
            print(f"P2 {name}: exit 0 in {wall:.1f} s; {head}; rank 0 "
                  f"launches {launches}; malicious weight a round "
                  f"{[round(v, 5) for v in mal]}, final {mal[-1]:.5f} "
                  f"against the CI's bar 0.1 "
                  f"({'below' if mal[-1] < 0.1 else 'not below'}); {card}")
            out[name] = {"wall_s": wall, "malicious_weight": mal,
                         "launches": launches[op_name], "op": op_name}
        sharded = out["population"]["malicious_weight"]
        check(sharded == ci_malicious,
              f"P3: the sharded population's malicious weights {sharded} "
              f"equal the unsharded run's {ci_malicious}")
        print(f"P3 population-smoke, C = {CI_COHORT} over {CI_RANKS} "
              f"ranks: its {CI_ROUNDS} malicious weights equal the "
              f"unsharded run's (its slots trained in the ranks' groups) "
              f"bitwise; last {sharded[-1]:.5f} against the CI's bar "
              f"{CI_GATE}")
        out["nccl"] = nccl
        out["wall_s"] = time.perf_counter() - t0
        return out
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def phase_population(torch, card, n, compressor="identity", chunk=False):
    """POP_ROUNDS rounds of ``PopulationTrainer`` over a synthetic
    population of ``n`` clients (``make_synthetic_population``, 16 rows a
    client drawn on gather from keyed Philox counters, on the card; a
    cohort's draw equal to the same draw on the CPU, the labels bitwise
    and the images within 1e-5), ``fedtest-cnn`` at full width, a cohort of
    POP_COHORT, POP_TESTERS testers from it, cross-testing in tiles of
    POP_BLOCK models, ``random_weights`` from 20 % of the clients, 10
    local steps of batch 32. Each round is held to its draws
    (``check_cohort_round``); the launch counts, set to 0 before the
    rounds, must show one ``weighted_aggregate`` a round (``int8``: one
    ``dequant_aggregate``) and no other kernel, and the last round's
    step-7 output must equal the plain version. With ``int8``, POP_UNTOUCHED
    error-feedback rows of clients outside each round's cohort (drawn with
    a fixed seed) must come out of the round bitwise. The allocator's
    peak is read from a reset before the population is built. With
    ``chunk``, the same rounds again from the same init as one eager round
    and a chunk of POP_RPC replays (``population_chunk``). Returns the
    phase's numbers."""
    import numpy as np
    from repro_torch.config import FedConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.engine import PopulationTrainer
    from repro_torch.data import make_synthetic_population
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves

    label = f"population N={n:,}" + ("" if compressor == "identity"
                                     else f" {compressor}")
    # the last phase's timing wrappers hold its tensors in reference
    # cycles (a wrapped method's record names the data that holds it):
    # collect them, so that its leftovers do not count in this peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    data = make_synthetic_population(n, per_client=POP_PER_CLIENT,
                                     image_size=32, channels=3, seed=0)
    shards_err = keyed_shards_on_cpu(torch, label, data)
    fed = FedConfig(num_users=n, num_testers=POP_TESTERS,
                    num_malicious=n // 5, attack="random_weights",
                    local_steps=10, cohort=POP_COHORT,
                    participation=POP_COHORT / n, compressor=compressor,
                    rounds=POP_ROUNDS)
    tc = TrainConfig(optimizer="sgd", lr=0.05, schedule="constant",
                     batch_size=32, grad_clip=0.0)
    trainer = PopulationTrainer(build_model(get_config("fedtest-cnn")), fed,
                                tc, device="cuda",
                                crosstest_block=POP_BLOCK,
                                testers_from_cohort=True)
    state = trainer.init()
    n_params = trainer.model.param_count(state.global_params)
    check(n_params == 188_810, f"fedtest-cnn has {n_params} params")
    print(f"{label}: {n_params:,} params, cohort {trainer.capacity}, "
          f"{fed.num_testers} testers from it, {fed.num_malicious:,} "
          f"random_weights attackers, tiles of {POP_BLOCK}; set-up "
          f"{time.perf_counter() - t0:.2f} s")

    step_ms, seen = {}, {}

    def timed(step, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            step_ms[step] = step_ms.get(step, 0.0) + (
                time.perf_counter() - t) * 1e3
            seen[step] = (args, out)
            return out
        return run

    backend = trainer.backend
    for step, method in (("train", "train"), ("attack", "apply_attack"),
                         ("compress", "compress_exchange"),
                         ("cross_test", "cross_test"),
                         ("aggregate", "weighted_sum"),
                         ("aggregate", "compressed_sum")):
        setattr(backend, method, timed(step, getattr(backend, method)))
    data.cohort_train = timed("gather", data.cohort_train)
    data.tester_batches = timed("gather", data.tester_batches)

    kernel_ops = ops()
    rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    reset_counts(kernel_ops)
    walls, corrupted, rows, eager_metrics = [], [], [], []
    for _ in range(POP_ROUNDS):
        step_ms.clear()
        before = state.scores.scores
        t = time.perf_counter()
        draws = timed("draw", trainer.draw)(state, data)
        if compressor != "identity":
            cohort = set(draws.cohort.ids)
            outside = [c for c in rng.permutation(n)[:POP_UNTOUCHED
                                                      + len(cohort)]
                       if c not in cohort][:POP_UNTOUCHED]
            kept_rows = state.comp_state[outside].clone()
        state, metrics = trainer.run_round(state, data, draws=draws)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        eager_metrics.append(metrics)
        (_, _, models, *_), attacked = seen["attack"]
        corrupted.append(check_cohort_round(
            torch, label, trainer, draws, before, metrics,
            slot_unchanged(torch, models, attacked)))
        if compressor != "identity":
            check(torch.equal(state.comp_state[outside], kept_rows),
                  f"{label}: {len(outside)} error-feedback rows outside "
                  f"the cohort are unchanged")
        values = [float(metrics["local_loss"]),
                  float(metrics["malicious_weight"])]
        check(all(math.isfinite(v) for v in values)
              and all(bool(torch.isfinite(p).all())
                      for p in tree_leaves(state.global_params)),
              f"{label}: finite loss, malicious weight and params")
        rest = walls[-1] - sum(step_ms.values())
        rows.append({"round": state.round_idx, "wall_ms": walls[-1],
                     "cohort": len(draws.cohort.ids),
                     "corrupted": corrupted[-1],
                     "malicious_weight": values[1], "steps_ms": dict(
                         step_ms, rest=rest)})
        print(f"{label} round {state.round_idx}: wall {walls[-1]:.3f} ms, "
              f"cohort {len(draws.cohort.ids)}, {corrupted[-1]} slots "
              f"corrupted, "
              f"local_loss {values[0]:.4f}, malicious_weight "
              f"{values[1]:.5f}; steps ms: " + "  ".join(
                  f"{k} {v:.3f}" for k, v in step_ms.items())
              + f"  rest {rest:.3f}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = {name: op.launches for name, op in kernel_ops.items()}
    op_name = ("weighted_aggregate" if compressor == "identity"
               else "dequant_aggregate")
    per_round = aggregate_launches(op_name, state.global_params)
    worst = held_to_plain(torch, label, op_name, *seen["aggregate"])
    want = {name: (per_round * POP_ROUNDS if name == op_name else 0)
            for name in kernel_ops}
    check(counts == want
          and kernel_ops["decode_attention"].merge_launches == 0,
          f"{label} launches {counts}, want {want}")
    print(f"{label}: launches {counts}; the last round's {op_name} output "
          f"== plain version on its own inputs (max |err| {worst:.3g}); "
          f"allocator peak {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f}"
          f" GiB above the {base / 2**30:.3f} GiB held before it); {card}")
    out = {"clients": n, "cohort": POP_COHORT, "testers": POP_TESTERS,
           "compressor": compressor, "rounds": rows,
           "launches": counts[op_name], "op": op_name,
           "max_abs_err": worst, "peak_bytes": peak,
           "peak_above_base_bytes": peak - base,
           "shards_cpu_max_abs_err": shards_err}
    if chunk:
        # the data's step timers synchronise, which a capture refuses
        del data.cohort_train, data.tester_batches
        seen.clear()
        out["chunk"] = population_chunk(
            torch, card, label, trainer, data, state, eager_metrics, walls,
            op_name, per_round)
    return out


def aggregate_launches(op_name, params) -> int:
    """Step 7's kernel launches a round: ``weighted_aggregate``'s grouped
    launches over ``params``' leaves, or one ``dequant_aggregate``."""
    from repro_torch.kernels.weighted_aggregate import plan_launches
    from repro_torch.utils import tree_leaves
    if op_name != "weighted_aggregate":
        return 1
    sizes = [p.numel() for p in tree_leaves(params)]
    return len(plan_launches(sizes, [True] * len(sizes), 4))


def held_to_plain(torch, label, op_name, args, out) -> float:
    """A population round's step 7 (``weighted_sum`` or
    ``compressed_sum``, called with ``args``, gave ``out``) against the
    plain version on the same operands, rtol 1e-5, atol 1e-6; returns
    the largest |error|."""
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate_ref
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate_ref
    from repro_torch.utils import tree_leaves
    if op_name == "weighted_aggregate":
        models, weights, _ = args
        stack, w = cohort_operands(models, weights)
        pairs = [(got.reshape(-1), weighted_aggregate_ref(
            x.reshape(x.shape[0], -1), w))
            for got, x in zip(tree_leaves(out), tree_leaves(stack))]
    else:
        # the population backend's payloads go out tagged with the plan
        comp, (plan, payloads), _, weights = args
        w = slot_weights(plan, weights)
        pairs = [(out, dequant_aggregate_ref(
            w, payloads["scales"], payloads["q"], comp.chunk)[:comp.dim])]
        check(tuple(payloads["q"].shape) == (POP_COHORT, comp.padded_dim),
              f"{label}: int8 payloads {tuple(payloads['q'].shape)}")
    worst = 0.0
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        worst = max(worst, float((got - want).abs().max()))
    return worst


def keyed_shards_on_cpu(torch, label, data) -> float:
    """A cohort's keyed shards drawn on the card against the same draw
    on the CPU (the population's prototypes copied there): the labels
    bitwise, the images within 1e-5 (the normals' ``log``, ``cos`` and
    ``sin`` may round apart by an ulp). Returns the images' largest
    |error|."""
    import dataclasses
    n = data.num_clients
    ids = torch.cat([torch.arange(4), torch.randperm(
        n, generator=torch.Generator().manual_seed(1))[:POP_COHORT - 8],
        torch.arange(n - 4, n)])
    on_cpu = dataclasses.replace(data, protos=data.protos.cpu())
    gx, gy = data.cohort_train(ids.to(data.protos.device))
    cx, cy = on_cpu.cohort_train(ids)
    check(torch.equal(gy.cpu(), cy),
          f"{label}: the keyed labels on the card equal the CPU's")
    torch.testing.assert_close(gx.cpu(), cx, rtol=1e-5, atol=1e-5)
    err = float((gx.cpu() - cx).abs().max())
    print(f"{label}: a cohort's keyed shards ({tuple(gx.shape)}) on the "
          f"card against the CPU's: labels bitwise, images max |err| "
          f"{err:.3g}")
    return err


def population_chunk(torch, card, label, trainer, data, state, eager,
                     walls, op_name, per_round):
    """The population phase's POP_ROUNDS eager rounds (``state`` after
    them, ``eager`` their metrics) again from the same init through a
    trainer at ``rounds_per_call`` = POP_RPC: one eager round, under
    ``torch.cuda.set_sync_debug_mode("error")`` (the keyed gather and
    the round read nothing to the host), then one chunk of POP_RPC
    replays of one CUDA graph of the round. The end state (params,
    scores, error feedback, generator) and every round's metrics must
    equal the eager run's bitwise; one capture; the wrappers, set to 0
    before the eager round, count its launches, the warm-up's and the
    capture's, and no other kernel. Then POP_RPC replays back
    to back (CUDA events around each: the device's ms of a round; the
    host clock around them all: graphed), one replay profiled, which
    must launch ``op_name``'s kernel ``per_round`` times, and that
    replay's step-7 output (the operands the capture recorded, rewritten
    by each replay) held to the plain version. The allocator's peak is
    read from a reset before the chunk's trainer is built."""
    import dataclasses
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graphed = dataclasses.replace(trainer, rounds_per_call=POP_RPC)
    captures, recorded = [], {}
    capture = graphed._capture

    def counting(buf):
        captures.append(buf)
        return capture(buf)
    graphed._capture = counting
    backend = graphed.backend
    for method in ("weighted_sum", "compressed_sum"):
        def record(*args, _fn=getattr(backend, method)):
            out = _fn(*args)
            recorded["aggregate"] = (args, out)
            return out
        setattr(backend, method, record)

    g_state = graphed.init()
    kernel_ops = ops()
    torch.cuda.synchronize()
    reset_counts(kernel_ops)
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g_state, first = graphed.run_round(g_state, data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    g_state, stacked = graphed.run_chunk(g_state, data)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t) * 1e3
    counted = {name: op.launches for name, op in kernel_ops.items()}
    want = {name: (3 * per_round if name == op_name else 0)
            for name in kernel_ops}
    check(counted == want,
          f"{label}: the wrappers counted {counted} over the eager round "
          f"and the chunk, want {want} (the eager round's, the warm-up's "
          f"and the capture's; a replay calls no wrapper)")
    check(len(captures) == 1 and graphed.chunk.graph is not None,
          f"{label}: one CUDA graph captured, got {len(captures)}")
    n = _bitwise(torch, state, g_state,
                 f"{label}: 1 eager round and a chunk of {POP_RPC} replays "
                 f"against {POP_ROUNDS} eager rounds")
    rounds = [first] + [{k: v[i] for k, v in stacked.items()}
                        for i in range(POP_RPC)]
    differ = sorted({k for i, m in enumerate(rounds) for k, v in m.items()
                     if not torch.equal(_bits(torch, v),
                                        _bits(torch, eager[i][k]))})
    check(not differ and len(rounds) == len(eager),
          f"{label}: every round's metrics bitwise the eager rounds' "
          f"(differ: {differ})")

    graph = graphed.chunk.graph
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(POP_RPC)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    graphed_round = (time.perf_counter() - t) * 1e3 / POP_RPC
    device_ms = [start.elapsed_time(end) for start, end in events]
    counts, trace_ms, trace_launches = graph_launches(
        torch, graph.replay, [GRAPH_KERNELS[op_name]])
    want = {GRAPH_KERNELS[op_name]: per_round}
    check(dict(counts) == want,
          f"{label}: a replay launches {dict(counts)} by the profiler, "
          f"want {want}")
    worst = held_to_plain(torch, label, op_name, *recorded["aggregate"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    steady = walls[1:]
    eager_round = sum(steady) / len(steady)
    device_round = sum(device_ms) / len(device_ms)
    out = {"rounds": POP_ROUNDS, "rounds_per_call": POP_RPC,
           "tensors_bitwise": n, "eager_round_ms": eager_round,
           "chunk_first_eager_ms": first_ms, "first_chunk_ms": chunk_ms,
           "graphed_round_ms": graphed_round, "device_round_ms": device_ms,
           "device_round_mean_ms": device_round,
           "replay_launches": dict(counts),
           "replay_trace_launches": trace_launches,
           "replay_trace_device_ms": trace_ms,
           "launches": counted[op_name],
           "replays": POP_RPC * 2 + 1,
           "replay_max_abs_err": worst, "peak_bytes": peak,
           "phase_s": time.perf_counter() - t0, "card": card}
    print(f"{label} chunk: 1 eager round (no sync, {first_ms:.3f} ms) + "
          f"{POP_RPC} replays bitwise {POP_ROUNDS} eager rounds ({n} "
          f"tensors, every round's metrics); a round: eager "
          f"{eager_round:.3f} ms, graphed {graphed_round:.3f} ms, device "
          f"{device_round:.3f} ms; first chunk (warm-up + capture + "
          f"{POP_RPC} replays) {chunk_ms:.1f} ms; a replay launches "
          f"{dict(counts)} of {trace_launches} kernels ({trace_ms:.3f} ms "
          f"by the profiler), its {op_name} output == plain version (max "
          f"|err| {worst:.3g}); allocator peak {peak / 2**30:.3f} GiB; "
          f"phase {out['phase_s']:.1f} s; {card}")
    return out


def phase_comparison(torch, card):
    """The paper's comparison (Figs. 4-5) through the example twin's
    ``run_curve`` at its full scale (20 users, ``fedtest-cnn``, 20,000
    CIFAR-like samples): COMPARE_ROUNDS rounds of each scheme against
    COMPARE_MALICIOUS ``random_weights`` attackers at scale 4. Every
    value must be finite, and FedTest's last malicious weight below
    FedAvg's, which pays by sample count."""
    from repro_torch.examples.fedtest_cifar import AGGREGATORS, run_curve
    curves = {}
    for agg in AGGREGATORS:
        t0 = time.perf_counter()
        hist = run_curve("cifar_like", agg, COMPARE_MALICIOUS,
                         COMPARE_ROUNDS, fast=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acc, mal = hist["global_accuracy"], hist["malicious_weight"]
        check(len(acc) == len(mal) == COMPARE_ROUNDS
              and all(math.isfinite(v) for v in acc + mal),
              f"comparison {agg}: finite curves, got {acc} {mal}")
        print(f"comparison {agg}: global_acc "
              f"{[round(v, 4) for v in acc]}  malicious_weight "
              f"{[round(v, 5) for v in mal]}  ({wall:.2f} s with set-up; "
              f"{card})")
        curves[agg] = {"global_accuracy": acc, "malicious_weight": mal,
                       "wall_s": wall}
    last = {agg: c["malicious_weight"][-1] for agg, c in curves.items()}
    check(last["fedtest"] < last["fedavg"],
          f"FedTest's last malicious weight {last['fedtest']} below "
          f"FedAvg's {last['fedavg']}")
    return curves


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


def _state_tensors(state):
    """A round state's tensors by name: params, the three score fields,
    the generator's state and the error feedback where there is one."""
    from repro_torch.utils import tree_leaves
    out = {f"param {i}": t
           for i, t in enumerate(tree_leaves(state.global_params))}
    out.update({f"scores.{k}": v for k, v in state.scores._asdict().items()})
    out["gen_state"] = state.gen.get_state()
    if state.comp_state is not None:
        out["comp_state"] = state.comp_state
    return out


def _bits(torch, t):
    """A tensor's bit pattern, so that NaNs compare by their bits."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _bitwise(torch, one, two, what):
    a, b = _state_tensors(one), _state_tensors(two)
    differ = [k for k in a if not torch.equal(_bits(torch, a[k]),
                                              _bits(torch, b[k]))]
    check(a.keys() == b.keys() and not differ
          and one.round_idx == two.round_idx,
          f"{what}: bitwise equal ({len(a)} tensors; differ: {differ})")
    return len(a)


def phase_durability(torch, card, scratch):
    """Path E's flags (the coalition, trust, stragglers): DURABLE_ROUNDS
    rounds unbroken, against DURABLE_SPLIT rounds, a checkpoint through
    ``CheckpointManager``, a trainer built anew by ``build`` restoring it,
    and the rest; every param, the three score fields and the generator
    state must be bitwise equal. Then the train CLI in a subprocess with
    ``--ckpt-dir``, sent SIGTERM once its first checkpoint is on disk: it
    must exit 1 with the reference's message and have saved the round it
    reached; ``--resume`` in a second subprocess runs it on to
    DURABLE_ROUNDS, and that final checkpoint must equal the unbroken
    run's state bitwise. Returns the numbers printed."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import build, parse_args

    def rounds_of(trainer, state, data, n):
        for _ in range(n):
            state, _ = trainer.run_round(state, data)
        return state

    argv = E_ARGS + ["--rounds", str(DURABLE_ROUNDS)]
    trainer, data, _ = build(parse_args(argv))
    whole = rounds_of(trainer, trainer.init(), data, DURABLE_ROUNDS)
    trainer, data, _ = build(parse_args(argv))
    part = rounds_of(trainer, trainer.init(), data, DURABLE_SPLIT)
    mgr = CheckpointManager(os.path.join(scratch, "inproc"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = trainer.save_checkpoint(mgr, part)
    save_ms = (time.perf_counter() - t0) * 1e3
    again, data, _ = build(parse_args(argv))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, at = again.restore_checkpoint(mgr)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(at == DURABLE_SPLIT, f"restored round {at}")
    _bitwise(torch, part, state, "the restored state against the saved")
    resumed = rounds_of(again, state, data, DURABLE_ROUNDS - DURABLE_SPLIT)
    n = _bitwise(torch, whole, resumed,
                 f"{DURABLE_SPLIT} rounds + checkpoint + restore + "
                 f"{DURABLE_ROUNDS - DURABLE_SPLIT} against "
                 f"{DURABLE_ROUNDS} unbroken")
    size = os.path.getsize(path)
    print(f"durability: {DURABLE_SPLIT} + {DURABLE_ROUNDS - DURABLE_SPLIT} "
          f"rounds through a checkpoint == {DURABLE_ROUNDS} unbroken, "
          f"bitwise ({n} tensors); save {save_ms:.3f} ms, restore "
          f"{restore_ms:.3f} ms ({size:,} bytes; {card})")

    # the CLI: SIGTERM at a round boundary, then --resume. Hand the
    # blocks this process's allocator keeps (path B100's cross-testing
    # alone reserves tens of GB) back to the card first: the CLI's own
    # process needs its share
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    print(f"durability: {reserved / 2**30:.2f} GiB reserved by this "
          f"process, {torch.cuda.memory_reserved() / 2**30:.2f} GiB after "
          "empty_cache")
    ckpt = os.path.join(scratch, "cli")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cli = [sys.executable, "-m", "repro_torch.launch.train", *E_ARGS,
           "--ckpt-dir", ckpt, "--out", os.path.join(scratch, "out")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cli + ["--rounds", "1000", "--ckpt-every", "1"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        while not (os.path.isdir(ckpt) and any(
                f.startswith("ckpt_") for f in os.listdir(ckpt))):
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                proc.kill()
                out, err = proc.communicate(timeout=60)
                check(False, f"the CLI wrote a checkpoint: rc "
                      f"{proc.returncode}, {err[-2000:]}")
            time.sleep(0.02)
        first_ckpt_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
        sigterm_ms = (time.perf_counter() - t1) * 1e3
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    stopped = re.search(r"interrupted at round (\d+) \(state saved\)", err)
    check(proc.returncode == 1 and stopped is not None,
          f"the CLI exits 1 on SIGTERM with the reference's message: "
          f"rc {proc.returncode}, {err[-500:]}")
    stopped = int(stopped.group(1))
    check(CheckpointManager(ckpt).latest_step() == stopped
          and 1 <= stopped < DURABLE_ROUNDS,
          f"the CLI saved round {stopped} as its newest checkpoint")
    print(f"durability: CLI SIGTERM at round {stopped} (first checkpoint "
          f"{first_ckpt_s:.2f} s after start, SIGTERM to exit "
          f"{sigterm_ms:.1f} ms; {card})")
    done = subprocess.run(cli + ["--rounds", str(DURABLE_ROUNDS),
                                 "--resume"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    check(done.returncode == 0
          and f"resuming from round {stopped}" in done.stdout,
          f"--resume ran on: rc {done.returncode}, {done.stderr[-500:]}")
    final, at = trainer.restore_checkpoint(CheckpointManager(ckpt))
    check(at == DURABLE_ROUNDS, f"the resumed CLI saved round {at}")
    _bitwise(torch, whole, final,
             f"the CLI's SIGTERM + --resume to round {DURABLE_ROUNDS} "
             "against the unbroken run")
    print(f"durability: the CLI stopped at round {stopped} and resumed to "
          f"{DURABLE_ROUNDS} == the unbroken run, bitwise")
    return {"save_ms": save_ms, "restore_ms": restore_ms,
            "checkpoint_bytes": size, "sigterm_round": stopped,
            "sigterm_to_exit_ms": sigterm_ms,
            "first_checkpoint_s": first_ckpt_s, "card": card}


def phase_serve_checkpoint(torch, card, scratch):
    """The reduced ``qwen2-0.5b`` (f32), its params written by the port's
    ``CheckpointManager`` through a trainer's ``save_checkpoint``, served
    by ``repro_torch.launch.serve`` with ``--ckpt-dir`` on the card: the
    params read back, the greedy tokens and every step's logits must
    equal serving the same params directly on the same prompt."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import FedConfig, TrainConfig, reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.core import FederatedTrainer
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves

    cfg = reduce_for_smoke(get_config("qwen2-0.5b")).replace(dtype="float32")
    writer = FederatedTrainer(build_model(cfg),
                              FedConfig(num_users=2, num_testers=1),
                              TrainConfig(), device="cuda")
    saved = writer.init()
    ckpt = os.path.join(scratch, "serve")
    writer.save_checkpoint(CheckpointManager(ckpt), saved, step=7)
    args = serve_mod.parse_args(["--device", "cuda", "--smoke", "--batch",
                                 "4", "--prompt-len", "64", "--gen", "8",
                                 "--ckpt-dir", ckpt])
    model, params, batch, gen = serve_mod.build(args)
    tokens = batch["tokens"]
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(saved.global_params))),
        "the served params are the checkpoint's")
    logits = {}

    def keep(name):
        def on_step(i, out):
            logits[(name, i)] = out.clone()
        return on_step

    got = serve_mod.serve(model, params, batch, args.gen, 0.0, gen,
                          on_step=keep("checkpoint"))
    want = serve_mod.serve(model, saved.global_params, batch, args.gen,
                           0.0, gen, on_step=keep("direct"))
    check(torch.equal(got["tokens"], want["tokens"])
          and all(torch.equal(logits[("checkpoint", i)],
                              logits[("direct", i)])
                  for i in range(args.gen)),
          "serving the checkpoint == serving its params directly (tokens "
          "and logits)")
    print(f"serve --ckpt-dir: {cfg.name} from a round-7 checkpoint, batch "
          f"{tokens.shape[0]}, prompt {tokens.shape[1]}, {args.gen} greedy "
          f"tokens and {args.gen} logits == the params served directly "
          f"({card})")


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
    model, params, batch, gen = serve_mod.build(args)
    tokens = batch["tokens"]
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
        warm = serve_mod.serve(model, params, batch, args.gen,
                               args.temperature, gen)
        del warm
        finite.clear()
        torch.cuda.synchronize()
        reset_counts(kernel_ops)
        res = serve_mod.serve(model, params, batch, args.gen,
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

    serve_teacher_forcing(torch, "serve", model, params, batch,
                          gen_tokens, step1["logits"], SERVE_TF_TOL,
                          SERVE_TF_MEAN_TOL)
    numbers = serve_numbers(torch, "serve", model, params, batch, res,
                            args.gen, card)
    return counts, numbers


def serve_teacher_forcing(torch, label, model, params, batch, gen_tokens,
                          step1_logits, tol, mean_tol):
    """Decode step 1 (the first generated token, at position S; a vlm's
    at P + S, after its P patches) against a full forward over the prompt
    batch and that token: the largest and the mean |diff| must stay
    within ``tol`` and ``mean_tol`` of the logits' std. Returns the
    numbers."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    off = model.cfg.num_patches if model.cfg.family == "vlm" else 0
    full = model.forward_train(params, dict(batch, tokens=torch.cat(
        [tokens, gen_tokens[:, :1]], dim=1)))[:, off + S].float()
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


def serve_numbers(torch, label, model, params, batch, res, gen_len, card):
    """The serve metrics of one ``serve`` run, beside the device's own time
    for one prefill and one decode step: each captured in a CUDA graph and
    replayed, so no host work sits between its kernels; against the host
    clock, the rest is the device idling while Python dispatches."""
    from repro_torch.launch.serve import cache_capacity
    B, S = batch["tokens"].shape
    steps = gen_len - 1
    cap = cache_capacity(model, S, gen_len)
    cache, last = res["cache"], res["tokens"][:, -1:]
    device = {
        "prefill_device_ms": graph_ms(torch, lambda: model.prefill(
            params, batch, cache_len=cap), 1),
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
    model, params, batch, gen = serve_mod.build(args)
    tokens = batch["tokens"]
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
        warm = serve_mod.serve(model, params, batch, args.gen,
                               args.temperature, gen)
        del warm
        finite.clear()
        torch.cuda.synchronize()
        reset_counts(kernel_ops)
        res = serve_mod.serve(model, params, batch, args.gen,
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
        torch, "ssm serve (bf16)", model, params, batch, gen_tokens,
        step1["logits"], SSM_TF_BF16_TOL, SSM_TF_BF16_MEAN_TOL)
    model32 = build_model(cfg.replace(dtype="float32"))
    params32 = tree_map(lambda t: t.float(), params)
    _, cache32 = model32.prefill(params32, {"tokens": tokens})
    step1_32, _ = model32.decode_step(params32, cache32, gen_tokens[:, :1])
    del cache32
    tf_f32 = serve_teacher_forcing(
        torch, "ssm serve (f32 weights)", model32, params32, batch,
        gen_tokens, step1_32[:, 0].float(), SSM_TF_TOL, SSM_TF_MEAN_TOL)
    del params32
    numbers = serve_numbers(torch, "ssm serve", model, params, batch, res,
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


def phase_moe_serve(torch, card, label, arch, overrides, reference_params):
    """A moe or hybrid LM in bf16 through the serve launcher's code path
    (``build(args, **overrides)``, then ``serve``), as ``phase_serve``
    drives qwen2-0.5b: one warm-up pass, then the measured pass with every
    kernel count set to 0 just before it, read after the prefill and
    again after the decode steps. The prefill routes the MoE by capacity,
    decode dropless. Launches: ``flash_attention`` once an attention
    layer a prefill, ``ssd_scan`` once a mamba layer a prefill,
    ``decode_attention`` and its merge once an attention layer a decode
    step, no other kernel. Each kernel's last call is held against its
    plain version on its own inputs; decode step 1 of the model rebuilt
    with a dropless prefill against its full forward (teacher forcing),
    in bf16 and, where the model's f32 copy fits, in f32. Prints host and
    device (CUDA graph) times, the idle share and the allocator peak.
    Returns the numbers printed."""
    import dataclasses as dc
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.ssm as ssm_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.ssd_scan import ssd_ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves, tree_map

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = serve_mod.parse_args(["--arch", arch] + MOE_SERVE_ARGS)
    model, params, batch, gen = serve_mod.build(args, **overrides)
    tokens = batch["tokens"]
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    cfg = model.cfg
    n_params = model.param_count(params)
    check(n_params == cfg.param_count(),
          f"{label}: {n_params} params, the analytic count "
          f"{cfg.param_count()}")
    if reference_params is not None:
        check(n_params == reference_params,
              f"{label}: {cfg.name} has {n_params} params, the reference "
              f"counts {reference_params}")
        print(f"{label}: param_count() {cfg.param_count():,} (the "
              f"reference's count_params_analytic: {reference_params:,}), "
              f"active {cfg.active_param_count():,}")
    else:
        full = get_config(arch)
        period = full.replace(num_layers=overrides["num_layers"])
        print(f"reduced: {label} runs one period of {full.name}'s layout "
              f"({cfg.num_layers} layers: attention at slot "
              f"{cfg.attn_offset}, MoE on the odd slots, {cfg.num_experts} "
              f"experts top-{cfg.num_experts_per_tok}) with its head_dim "
              f"{cfg.head_dim}, ssm_head_dim {cfg.ssm_head_dim} and "
              f"ssm_state {cfg.ssm_state}, at a quarter of its d_model, d_ff "
              f"and heads ({cfg.d_model}, {cfg.d_ff}, {cfg.num_heads}/"
              f"{cfg.num_kv_heads}): {n_params:,} params. One period at its "
              f"published widths is {period.param_count():,} params, "
              f"{period.param_count() * 2 / 1e9:.1f} GB in bf16, over the "
              f"card's 80 GB; the whole model {full.param_count():,}")
    slots = params["layers"]
    routers = [sl["moe"]["router"] for sl in slots.values() if "moe" in sl]
    banks = [sl["moe"][n] for sl in slots.values() if "moe" in sl
             for n in ("w_gate", "w_up", "w_down")]
    check(routers and all(r.dtype == torch.float32 for r in routers)
          and all(b.dtype == torch.bfloat16 for b in banks)
          and params["embed"].dtype == torch.bfloat16,
          f"{label}: f32 routers, bf16 expert banks and embedding")
    attn_layers = sum(cfg.uses_attention(i) for i in range(cfg.num_layers))
    mamba_layers = cfg.num_layers - attn_layers
    B, S = tokens.shape
    print(f"{label}: {cfg.name} ({n_params:,} params, {cfg.num_layers} "
          f"layers: {attn_layers} attention, {mamba_layers} mamba, "
          f"{sum(cfg.uses_moe(i) for i in range(cfg.num_layers))} MoE of "
          f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok}; "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
          f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), batch {B}, prompt {S}, gen {args.gen}; set-up "
          f"{t_build:.2f} s, {torch.cuda.memory_allocated() / 2**30:.3f} "
          f"GiB allocated")

    seen = {}

    def recorder(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            seen[name] = (a, kw, out)
            return out
        return run

    kernel_ops = ops()
    finite, step1, prefill_counts = [], {}, {}

    def on_step(i, logits):
        finite.append(torch.isfinite(logits).all())
        if i == 0:
            prefill_counts.update(
                {name: op.launches for name, op in kernel_ops.items()})
            prefill_counts["decode_attention merge"] = (
                kernel_ops["decode_attention"].merge_launches)
        if i == 1:
            step1["logits"] = logits[:, 0].float().clone()

    originals = (attn_mod.flash_attention, attn_mod.decode_attention,
                 ssm_mod.ssd_scan)
    attn_mod.flash_attention = recorder("flash", originals[0])
    attn_mod.decode_attention = recorder("decode", originals[1])
    ssm_mod.ssd_scan = recorder("ssd", originals[2])
    try:
        warm = serve_mod.serve(model, params, batch, args.gen,
                               args.temperature, gen)
        del warm
        finite.clear()
        torch.cuda.synchronize()
        reset_counts(kernel_ops)
        res = serve_mod.serve(model, params, batch, args.gen,
                              args.temperature, gen, on_step=on_step)
        counts = {name: op.launches for name, op in kernel_ops.items()}
        counts["decode_attention merge"] = (
            kernel_ops["decode_attention"].merge_launches)
    finally:
        (attn_mod.flash_attention, attn_mod.decode_attention,
         ssm_mod.ssd_scan) = originals
    steps = args.gen - 1
    want_prefill = {name: 0 for name in counts}
    want_prefill.update({"flash_attention": attn_layers,
                         "ssd_scan": mamba_layers})
    want = dict(want_prefill, **{"decode_attention": steps * attn_layers,
                                 "decode_attention merge":
                                     steps * attn_layers})
    check(prefill_counts == want_prefill and counts == want,
          f"{label} launches: prefill {prefill_counts}, whole pass "
          f"{counts}; want {want_prefill}, {want}")
    print(f"{label} launches: prefill {prefill_counts}; whole pass {counts} "
          f"(flash: 1 prefill x {attn_layers} attention layers; ssd_scan: 1 "
          f"prefill x {mamba_layers} mamba layers; decode: {steps} steps x "
          f"{attn_layers} attention layers)")
    check(len(finite) == args.gen and all(bool(f) for f in finite),
          f"{label}: finite logits at the prefill and every decode step")
    gen_tokens = res["tokens"]
    check(gen_tokens.shape == (B, args.gen)
          and bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size))
                   .all()), f"tokens {tuple(gen_tokens.shape)} in range")

    # each kernel's last call against its plain version on its own inputs
    worst = {}
    (q, k, v), kw, got = seen["flash"]
    want_out = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want_out.float(),
                               **ATTN_TOL["bfloat16"])
    worst["flash"] = float((got.float() - want_out.float()).abs().max())
    shapes = {"flash q": tuple(q.shape)}
    (q, kc, vc, lengths), kw, (out, lse) = seen["decode"]
    want_o, want_l = decode_attention_ref(q, kc, vc, lengths, **kw)
    torch.testing.assert_close(out.float(), want_o.float(),
                               **ATTN_TOL["bfloat16"])
    torch.testing.assert_close(lse, want_l, **ATTN_TOL["float32"])
    worst["decode out"] = float((out.float() - want_o.float()).abs().max())
    worst["decode lse"] = float((lse - want_l).abs().max())
    check(int(lengths.min()) == int(lengths.max()) == S + steps,
          f"{label}: the last decode step attends {S + steps} keys")
    shapes["decode cache"] = tuple(kc.shape)
    if mamba_layers:
        (x, dt, A, Bm, Cm, D), kw, (y, st) = seen["ssd"]
        check(tuple(x.shape) == (B, S, cfg.ssm_heads, cfg.ssm_head_dim)
              and tuple(Bm.shape[2:]) == (cfg.ssm_ngroups, cfg.ssm_state),
              f"{label}: the last scan's x {tuple(x.shape)}, B "
              f"{tuple(Bm.shape)}")
        _hold_ssd(torch, (y, st), ssd_ref(x, dt, A, Bm, Cm, D),
                  torch.bfloat16, worst)
        shapes["ssd_scan"] = tuple(x.shape) + (cfg.ssm_state,)
    print(f"{label}: the last layer's last prefill and decode kernel calls "
          f"== plain versions on their own inputs (shapes {shapes}; max "
          f"|err| {worst})")
    seen.clear()

    # teacher forcing, on the model rebuilt with a dropless prefill
    dropless = dc.replace(model, moe_dropless=True)
    bf16_tol = ((SSM_TF_BF16_TOL, SSM_TF_BF16_MEAN_TOL) if mamba_layers
                else (MOE_TF_TOL, MOE_TF_MEAN_TOL))

    def step1_of(m, p):
        _, cache = m.prefill(p, {"tokens": tokens}, cache_len=S + 2)
        lg, _ = m.decode_step(p, cache, gen_tokens[:, :1])
        return lg[:, 0].float()

    tf = {"bf16": serve_teacher_forcing(
        torch, f"{label} (bf16, dropless prefill)", dropless, params,
        batch, gen_tokens, step1_of(dropless, params), *bf16_tol)}
    peak_serve = torch.cuda.max_memory_allocated()
    if 4 * n_params < 24 * 2**30:
        model32 = build_model(cfg.replace(dtype="float32"),
                              moe_dropless=True)
        params32 = tree_map(lambda t: t.float(), params)
        tf["f32"] = serve_teacher_forcing(
            torch, f"{label} (f32 weights, dropless prefill)", model32,
            params32, batch, gen_tokens, step1_of(model32, params32),
            SSM_TF_TOL, SSM_TF_MEAN_TOL)
        del params32
    numbers = serve_numbers(torch, label, model, params, batch, res,
                            args.gen, card)
    numbers.update(params=n_params, teacher_forcing=tf,
                   launches=counts, peak_bytes=peak_serve,
                   build_s=t_build, max_abs_err=worst)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"{label}: allocator peak {peak_serve / 2**30:.3f} GiB over the "
          f"serve passes and the bf16 teacher forcing "
          f"({weights / 2**30:.3f} GiB of weights; {card})")
    if reference_params is not None and cfg.num_experts >= 64:
        cache, last = res["cache"], gen_tokens[:, -1:]
        numbers["decode_step_by_kernel"] = device_breakdown(
            torch, f"{label} decode step", lambda: model.decode_step(
                params, cache, last))
    del res, params
    return numbers


def upcast_in_place(tree) -> None:
    """Replace each tensor leaf of a nested dict by its f32 copy, leaf by
    leaf, so that the old leaf is freed before the next is copied."""
    for key, val in tree.items():
        if isinstance(val, dict):
            upcast_in_place(val)
        else:
            tree[key] = val.float()


def decode_step_bytes(params, cache, cfg, length: int) -> int:
    """The bytes one decode step must read: every weight the step uses
    (not the encoder, ``dec_pos``, ``patch_proj``, the cross-attention's
    K/V projections, or an untied embedding table, of which it gathers a
    row a sequence) and the cache rows it attends: the self-attention
    keys and values up to ``length`` and, for an encdec, the whole cross
    K/V."""
    from repro_torch.utils import tree_leaves
    skip = {"encoder", "enc_final_norm", "dec_pos", "patch_proj"}
    if not cfg.tie_embeddings:
        skip.add("embed")
    total = 0
    for name, sub in params.items():
        if name not in skip:
            total += sum(t.numel() * t.element_size()
                         for t in tree_leaves(sub))
    if cfg.family == "encdec":
        total -= sum(params["decoder"]["cross_attn"][n].numel()
                     * params["decoder"]["cross_attn"][n].element_size()
                     for n in ("wk", "wv", "bk", "bv")
                     if n in params["decoder"]["cross_attn"])
    kv = cache["self"] if cfg.family == "encdec" else cache["layers"]
    for t in tree_leaves(kv):
        total += t[:, :, :length].numel() * t.element_size()
    if cfg.family == "encdec":
        total += sum(t.numel() * t.element_size()
                     for t in tree_leaves(cache["cross"]))
    return total


def phase_frontend_serve(torch, card, peaks, label, argv, reference_params):
    """whisper-base (W) or pixtral-12b (V) at full width and depth in bf16
    through the serve launcher's code path (``build``, then ``serve``),
    as ``phase_serve`` drives qwen2-0.5b: one warm-up pass, then the
    measured pass with every kernel count set to 0 just before it, read
    after the prefill and again after the decode steps. Launches: W,
    ``flash_attention`` once an encoder layer and twice a decoder layer
    (self, cross) a prefill and once a decoder layer (cross) a decode
    step, ``decode_attention`` and its merge once a decoder layer a step;
    V, ``flash_attention`` once a layer a prefill, ``decode_attention``
    and its merge once a layer a step; no other kernel. The last call of
    each flash shape and the last decode call are held against the plain
    versions on their own inputs; decode step 1 against a full forward
    (teacher forcing, at P + S for V) in bf16 and on the weights upcast
    to f32 (V's on ``V_F32_ROWS`` sequences, its f32 weights replacing
    the bf16 ones). Prints host and device (CUDA graph) times, the idle
    share, the decode step's byte bound, the prefill's and a decode
    step's device time by kernel and the allocator peak. Returns the
    numbers printed."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    from repro_torch.models.frontend_stub import stub_shape
    from repro_torch.utils import tree_leaves

    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    args = serve_mod.parse_args(argv)
    model, params, batch, gen = serve_mod.build(args)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t_phase
    cfg = model.cfg
    encdec = cfg.family == "encdec"
    n_params = model.param_count(params)
    check(n_params == cfg.param_count() == reference_params,
          f"{label}: {cfg.name} has {n_params} params, the analytic count "
          f"{cfg.param_count()}, the reference's {reference_params}")
    stub = "frames" if encdec else "patches"
    norm = params["dec_final_norm" if encdec else "final_norm"]
    check(params["embed"].dtype == torch.bfloat16
          and all(t.dtype == torch.float32 for t in norm.values())
          and batch[stub].dtype == torch.bfloat16
          and tuple(batch[stub].shape) == stub_shape(cfg, args.batch),
          f"{label}: bf16 weights and {stub}, f32 norms")
    tokens = batch["tokens"]
    B, S = tokens.shape
    off = 0 if encdec else cfg.num_patches
    L = cfg.num_layers
    print(f"{label}: {cfg.name} ({n_params:,} params, "
          + (f"{cfg.encoder_layers} encoder layers over {cfg.encoder_seq} "
             f"stub frames, " if encdec else
             f"{cfg.num_patches} stub patches before the text, ")
          + f"{L} decoder layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}), batch {B}, prompt {S}, "
          f"gen {args.gen}, position table "
          f"{params['dec_pos'].shape[0] if encdec else 'none (RoPE)'}; "
          f"set-up {t_build:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")

    seen, by_shape = {}, collections.Counter()

    def flash_recorder(fn):
        def run(q, k, v, **kw):
            out = fn(q, k, v, **kw)
            key = (tuple(q.shape), tuple(k.shape), kw.get("causal", True))
            seen[key] = ((q, k, v), kw, out)
            by_shape[key] += 1
            return out
        return run

    def decode_recorder(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            seen["decode"] = (a, kw, out)
            return out
        return run

    kernel_ops = ops()
    finite, step1, prefill_counts = [], {}, {}

    def on_step(i, logits):
        finite.append(torch.isfinite(logits).all())
        if i == 0:
            prefill_counts.update(
                {name: op.launches for name, op in kernel_ops.items()})
            prefill_counts["decode_attention merge"] = (
                kernel_ops["decode_attention"].merge_launches)
        if i == 1:
            step1["logits"] = logits[:, 0].float().clone()

    originals = attn_mod.flash_attention, attn_mod.decode_attention
    attn_mod.flash_attention = flash_recorder(originals[0])
    attn_mod.decode_attention = decode_recorder(originals[1])
    try:
        warm = serve_mod.serve(model, params, batch, args.gen,
                               args.temperature, gen)
        del warm
        finite.clear()
        seen.clear()
        by_shape.clear()
        torch.cuda.synchronize()
        reset_counts(kernel_ops)
        res = serve_mod.serve(model, params, batch, args.gen,
                              args.temperature, gen, on_step=on_step)
        counts = {name: op.launches for name, op in kernel_ops.items()}
        counts["decode_attention merge"] = (
            kernel_ops["decode_attention"].merge_launches)
    finally:
        attn_mod.flash_attention, attn_mod.decode_attention = originals
    steps = args.gen - 1
    want_prefill = {name: 0 for name in counts}
    want_prefill["flash_attention"] = (cfg.encoder_layers + 2 * L if encdec
                                       else L)
    want = dict(want_prefill, **{
        "flash_attention": want_prefill["flash_attention"]
        + (steps * L if encdec else 0),
        "decode_attention": steps * L, "decode_attention merge": steps * L})
    check(prefill_counts == want_prefill and counts == want,
          f"{label} launches: prefill {prefill_counts}, whole pass "
          f"{counts}; want {want_prefill}, {want}")
    # the flash calls by shape: q, k and causal
    T_enc, Hq, Hkv, dh = cfg.encoder_seq, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    want_shapes = ({((B, T_enc, Hq, dh), (B, T_enc, Hkv, dh), False):
                    cfg.encoder_layers,
                    ((B, S, Hq, dh), (B, S, Hkv, dh), True): L,
                    ((B, S, Hq, dh), (B, T_enc, Hkv, dh), False): L,
                    ((B, 1, Hq, dh), (B, T_enc, Hkv, dh), False): steps * L}
                   if encdec else
                   {((B, off + S, Hq, dh), (B, off + S, Hkv, dh), True): L})
    check(dict(by_shape) == want_shapes,
          f"{label}: flash calls by shape {dict(by_shape)}, want "
          f"{want_shapes}")
    print(f"{label} launches: prefill {prefill_counts}; whole pass {counts}; "
          f"flash calls by (q, k, causal): {dict(by_shape)}")
    check(len(finite) == args.gen and all(bool(f) for f in finite),
          f"{label}: finite logits at the prefill and every decode step")
    gen_tokens = res["tokens"]
    check(gen_tokens.shape == (B, args.gen)
          and bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size))
                   .all()), f"tokens {tuple(gen_tokens.shape)} in range")

    # the last call of each flash shape and the last decode call against
    # the plain versions on their own inputs
    worst = {}
    for key in want_shapes:
        (q, k, v), kw, got = seen.pop(key)
        want_out = attention_ref(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want_out.float(),
                                   **ATTN_TOL["bfloat16"])
        worst[f"flash q{list(key[0])} k{list(key[1])}"] = float(
            (got.float() - want_out.float()).abs().max())
        del q, k, v, got, want_out
    (q, kc, vc, lengths), kw, (out, lse) = seen.pop("decode")
    want_o, want_l = decode_attention_ref(q, kc, vc, lengths, **kw)
    torch.testing.assert_close(out.float(), want_o.float(),
                               **ATTN_TOL["bfloat16"])
    torch.testing.assert_close(lse, want_l, **ATTN_TOL["float32"])
    worst["decode out"] = float((out.float() - want_o.float()).abs().max())
    worst["decode lse"] = float((lse - want_l).abs().max())
    check(int(lengths.min()) == int(lengths.max()) == off + S + steps
          and kc.shape[1] == serve_mod.cache_capacity(model, S, args.gen),
          f"{label}: the last decode step attends {off + S + steps} keys "
          f"of a {kc.shape[1]}-row cache")
    print(f"{label}: the last flash call of each shape and the last decode "
          f"call == plain versions on their own inputs (decode cache "
          f"{tuple(kc.shape)}; max |err| {worst})")
    del q, kc, vc, lengths, out, lse, want_o, want_l

    def step1_of(m, p, b, rows):
        _, cache = m.prefill(p, b, cache_len=off + S + 2)
        lg, _ = m.decode_step(p, cache, gen_tokens[:rows, :1])
        return lg[:, 0].float()

    tf = {"bf16": serve_teacher_forcing(
        torch, f"{label} (bf16)", model, params, batch, gen_tokens,
        step1["logits"], SERVE_TF_TOL, SERVE_TF_MEAN_TOL)}
    numbers = serve_numbers(torch, label, model, params, batch, res,
                            args.gen, card)
    step_bytes = decode_step_bytes(params, res["cache"], cfg,
                                   off + S + steps)
    bound_ms = step_bytes / peaks[0] * 1e3
    print(f"{label}: a decode step reads at least {step_bytes / 1e9:.3f} GB "
          f"(weights it uses and the cache rows it attends): bound "
          f"{bound_ms:.3f} ms at {peaks[0] / 1e12:.2f} TB/s, against "
          f"{numbers['decode_step_device_ms']:.3f} ms on the device alone "
          f"({card})")
    cache, last = res["cache"], gen_tokens[:, -1:]
    numbers["prefill_by_kernel"] = device_breakdown(
        torch, f"{label} prefill", lambda: model.prefill(
            params, batch, cache_len=serve_mod.cache_capacity(
                model, S, args.gen)))
    numbers["decode_step_by_kernel"] = device_breakdown(
        torch, f"{label} decode step", lambda: model.decode_step(
            params, cache, last))
    peak_serve = torch.cuda.max_memory_allocated()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"{label}: allocator peak {peak_serve / 2**30:.3f} GiB over the "
          f"serve passes, the kernel checks, the bf16 teacher forcing and "
          f"the CUDA graphs ({weights / 2**30:.3f} GiB of weights; {card})")
    del res, cache, last

    # f32: the same weights upcast, in place; V on its first V_F32_ROWS
    # sequences
    rows = B if encdec else V_F32_ROWS
    torch.cuda.reset_peak_memory_stats()
    upcast_in_place(params)
    model32 = build_model(cfg.replace(dtype="float32"),
                          max_target_positions=model.max_target_positions)
    batch32 = {k: (t.float() if t.is_floating_point() else t)[:rows]
               for k, t in batch.items()}
    tf["f32"] = serve_teacher_forcing(
        torch, f"{label} (f32 weights, {rows} sequences)", model32, params,
        batch32, gen_tokens[:rows], step1_of(model32, params, batch32, rows),
        SSM_TF_TOL, SSM_TF_MEAN_TOL)
    peak_f32 = torch.cuda.max_memory_allocated()
    del params, batch32
    numbers.update(params=n_params, launches=counts,
                   prefill_launches=prefill_counts,
                   flash_calls_by_shape={str(k): n
                                         for k, n in by_shape.items()},
                   teacher_forcing=tf, peak_bytes=peak_serve,
                   peak_f32_bytes=peak_f32, weight_bytes=weights,
                   decode_step_bytes=step_bytes,
                   decode_step_bound_ms=bound_ms, build_s=t_build,
                   max_abs_err=worst,
                   phase_s=time.perf_counter() - t_phase)
    print(f"{label}: f32 teacher forcing peak {peak_f32 / 2**30:.3f} GiB; "
          f"phase {numbers['phase_s']:.1f} s ({card})")
    return numbers


def adamw_round_bytes(cfg, users: int) -> int:
    """Bytes the LM round's local phase holds at AdamW's step, about (every
    leaf counted at 2 bytes where it is bf16): each client's bf16 weights,
    gradients and new weights (6 bytes a param), its old and new f32
    moments (16), and two f32 temporaries of its largest leaf (the step's
    update and the f32 copy of the weights); beside them the global bf16
    weights."""
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves

    n = cfg.param_count()
    largest = max(math.prod(s) for s in
                  tree_leaves(build_model(cfg).param_shapes()))
    return users * (22 * n + 8 * largest) + 2 * n


def sgd_round_bytes(cfg, users: int) -> int:
    """Bytes the LM round's local phase holds at an SGD step, about: each
    client's bf16 weights, gradients and new weights (6 bytes a param)
    and two f32 copies of its largest leaf (the step's f32 update and
    the f32 copy of the weights); beside them the global bf16 weights."""
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves

    n = cfg.param_count()
    largest = max(math.prod(s) for s in
                  tree_leaves(build_model(cfg).param_shapes()))
    return users * (6 * n + 8 * largest) + 2 * n


def phase_lm_population(torch, card):
    """Phase LP: phase L's round on the population tier through the train
    launcher (``LP_ARGS``: qwen2-0.5b whole, 256 clients, a cohort of 4,
    2 testers from it, 64 ``random_weights`` attackers), checked as
    ``phase_lm`` checks L (its cross-test twice a layer: the cohort's
    fold and the global model's column) and as path G (at most 4 filled
    slots, honest slots left bitwise by the attack, weights 0 and scores
    unchanged outside the cohort); its first 2 rounds again as one chunk
    of 2 replays, bitwise."""
    return phase_lm(torch, card, "LP", LP_ARGS, "flash_attention",
                    chunk=True)


def phase_vlm_round(torch, card):
    """Phase VR: pixtral-12b's round on its text (``VR_ARGS``) at its
    published widths with ``VR_LAYERS`` of its 40 layers, checked as
    ``phase_lm`` checks L (the folded flash launch at D = 128 equal to
    its blocks bitwise, ``weighted_aggregate`` once a table), and every
    client's trained ``patch_proj`` bitwise the global one: no gradient
    reaches it from a text batch, and SGD moves no leaf without one. The
    SGD reckoning is printed before the phase, beside AdamW's."""
    from repro_torch.configs import get_config

    users = int(VR_ARGS[VR_ARGS.index("--users") + 1])
    full = get_config("pixtral-12b")
    cut = full.replace(num_layers=VR_LAYERS)
    why = (f"{users} clients at an SGD step hold about "
           f"{sgd_round_bytes(full, users) / 2**30:.1f} GiB at full depth "
           f"(bf16 weights, gradients and new weights: 6 bytes a param; "
           f"two f32 temporaries of the largest leaf, the "
           f"{full.vocab_size:,} x {full.d_model:,} embedding; the global "
           f"weights), over the card's 80 GB; {VR_LAYERS} layer holds "
           f"about {sgd_round_bytes(cut, users) / 2**30:.1f} GiB (AdamW "
           f"would hold {adamw_round_bytes(cut, users) / 2**30:.1f} GiB "
           f"even here; the allocator peak below adds the activations)")
    print(f"phase VR: {why}")
    return phase_lm(torch, card, "VR", VR_ARGS, "flash_attention",
                    {"num_layers": VR_LAYERS}, reduced_why=why,
                    rounds=VR_ROUNDS, frozen_leaf="patch_proj")


def phase_moe_round(torch, card):
    """The LM round on granite-moe-1b-a400m (phase N): phase L's flags
    through the train launcher with ``N_LAYERS`` of its 24 layers, checked
    as ``phase_lm`` checks L (training launches no kernel, a cross-test
    and the global eval launch ``flash_attention`` once a layer, folded,
    ``weighted_aggregate`` twice a round, the folded launch equal to its
    blocks bitwise), and the global model's ``moe_aux`` printed. What
    this process still holds and the card's free memory are printed
    first: at 8 layers the reckoning is 44.1 GiB, and the round's peak
    leaves about 30 GiB of the card."""
    from repro_torch.configs import get_config

    free_memory(torch)
    held_memory(torch, "phase N")
    free, total = torch.cuda.mem_get_info()
    print(f"phase N: this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved; the "
          f"card has {free / 2**30:.3f} of {total / 2**30:.3f} GiB free "
          f"({card})")
    arch = "granite-moe-1b-a400m"
    argv = ["--arch", arch] + LM_ARGS
    users = int(LM_ARGS[LM_ARGS.index("--users") + 1])
    full = get_config(arch)
    cut = full.replace(num_layers=N_LAYERS)
    why = (f"{users} clients at AdamW's step hold about "
           f"{adamw_round_bytes(full, users) / 2**30:.1f} GiB at full depth "
           f"(bf16 weights, gradients and new weights, the old and the new "
           f"f32 moments: 22 bytes a param; two f32 temporaries of the "
           f"largest leaf; the global weights), over the card's 80 GB; "
           f"{N_LAYERS} layers hold about "
           f"{adamw_round_bytes(cut, users) / 2**30:.1f} GiB (the allocator "
           f"peak below adds the activations)")
    return phase_lm(torch, card, "N", argv, "flash_attention",
                    {"num_layers": N_LAYERS}, reduced_why=why)


def frontend_rows(rows):
    """(phase, timing row, what it times, the flash key ``(q shape, k
    shape, causal)`` whose calls it stands for) of phases W and V's flash
    rows."""
    enc, cross, step = rows["flash_attention W"]
    (pix,) = rows["flash_attention V"]
    w_enc = ((8, 1500, 8, 64), (8, 1500, 8, 64), False)
    return (
        ("W", enc, "whisper-base's encoder, one call: B=8, S=T=1500, "
         "Hq=Hkv=8, D=64, bf16, non-causal", w_enc),
        ("W", cross, "whisper-base's prefill cross-attention, one call: B=8, "
         "S=384 against T=1500, Hq=Hkv=8, D=64, bf16, non-causal",
         ((8, 384, 8, 64), (8, 1500, 8, 64), False)),
        ("W", step, "whisper-base's decode-step cross-attention, one call: "
         "B=8, S=1 against T=1500, Hq=Hkv=8, D=64, bf16, non-causal",
         ((8, 1, 8, 64), (8, 1500, 8, 64), False)),
        ("V", pix, "pixtral-12b's prefill, one call: B=8, S=T=1536 (1024 "
         "patches + 512 tokens), Hq=32, Hkv=8, D=128, bf16, causal",
         ((8, 1536, 32, 128), (8, 1536, 8, 128), True)))


def phase_tooling(torch, card, chip, serve_out, dryruns, dry_dir):
    """Phase T, the dry-run and roofline tooling (slice 16): the card's
    ``Chip``, its ``hbm_bytes`` the device's ``total_memory`` and within
    its data-sheet row's; the background dry-runs (``DRYRUNS``) each
    exit 0 with ``status: "ok"`` on its chip count and collective bytes
    above 0; the report's tables from their artifacts; then one card's
    roofline of the serve prefill on ``make_host_mesh``, beside the
    serve phase's device ms for it. Returns the phase's numbers."""
    import dataclasses

    from repro_torch.launch import report
    from repro_torch.roofline import CHIPS, roofline_terms

    props = torch.cuda.get_device_properties(0)
    row = next(c for key, c in CHIPS if key in props.name)
    print(f"phase T: the card's Chip {dataclasses.asdict(chip)} "
          f"(data-sheet row {row.name}: {row.hbm_bytes:.0f} B HBM, "
          f"{row.vmem_bytes:.0f} B shared memory an SM); {card}")
    check(chip.hbm_bytes == props.total_memory
          and 0.9 * row.hbm_bytes <= chip.hbm_bytes <= row.hbm_bytes,
          f"Chip.hbm_bytes {chip.hbm_bytes} is total_memory "
          f"{props.total_memory}, within 10 % under the row's "
          f"{row.hbm_bytes}")
    out = {"chip": dataclasses.asdict(chip), "dryruns": {}}
    for flags, chips, proc, log, t0 in dryruns:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            rc = None
        wall = time.perf_counter() - t0
        with open(log) as fh:
            tail = fh.read()[-3000:]
        tag = f"{flags[1]}__{flags[3]}__{flags[5]}"
        check(rc == 0, f"dry-run {' '.join(flags)} exited {rc} after "
              f"{wall:.1f} s: {tail}")
        with open(os.path.join(dry_dir, tag + ".json")) as fh:
            rec = json.load(fh)
        coll = rec.get("collective_bytes_per_device", 0)
        check(rec["status"] == "ok" and rec["num_chips"] == chips
              and coll > 0,
              f"dry-run {tag}: status {rec['status']}, "
              f"{rec.get('num_chips')} chips (want {chips}), collective "
              f"bytes {coll}")
        cost = rec["cost"]
        print(f"phase T dry-run {tag}: ok on {rec['num_chips']} chips, "
              f"per device {cost['flops_per_device']:.6e} FLOPs, "
              f"{cost['bytes_per_device']:.6e} B, collectives "
              f"{rec['collectives']} ({coll:.6e} B), peak intermediates "
              f"{rec['memory']['temp_bytes']} B; wall {wall:.1f} s (the "
              f"process's own {rec['wall_s']} s)")
        out["dryruns"][tag] = {"wall_s": wall, "record": rec}
    recs = report.load_all(dry_dir)
    print(report.dryrun_table(recs))
    for mesh in ("single", "multi"):
        print(f"roofline, mesh {mesh}:")
        print(report.roofline_table(recs, mesh))
    t0 = time.perf_counter()
    host = subprocess.run([sys.executable, "-W", "ignore", "-c",
                           HOST_DRYRUN], cwd=ROOT, env=dryrun_env(),
                          capture_output=True, text=True, timeout=600)
    check(host.returncode == 0, f"host dry-run: {host.stderr[-3000:]}")
    rec = json.loads(host.stdout.strip().splitlines()[-1])
    check(rec["status"] == "ok" and rec["num_chips"] == 1,
          f"host dry-run: {rec.get('status')} on {rec.get('num_chips')}")
    cost = rec["cost"]
    terms = roofline_terms(cost["flops_per_device"],
                           cost["bytes_per_device"],
                           rec["collective_bytes_per_device"], chip, 1)
    device_ms = serve_out["prefill_device_ms"]
    print(f"phase T one card's roofline, qwen2-0.5b serve prefill (bf16, "
          f"batch 8, prompt 512; the dry-run's blockwise twin, cache 512 "
          f"rows): compute {terms['compute_s'] * 1e3:.4f} ms, memory "
          f"{terms['memory_s'] * 1e3:.4f} ms, collective "
          f"{terms['collective_s'] * 1e3:.4f} ms ({terms['bottleneck']}); "
          f"the serve phase's prefill on the device "
          f"{device_ms:.4f} ms ({cost['flops_per_device']:.6e} FLOPs, "
          f"{cost['bytes_per_device']:.6e} B; dry-run "
          f"{time.perf_counter() - t0:.1f} s; {card})")
    out["host_prefill"] = {"roofline": terms, "record": rec,
                           "serve_prefill_device_ms": device_ms}
    return out


def main() -> int:
    # every phase on the allocator's expandable segments: with fixed
    # segments the LM rounds' AdamW steps fragmented the cache up to the
    # card's 80 GB, retrying allocations in a slow round, and phase L ran
    # out of memory at 63.9 GiB allocated (on PR 21's tree as well;
    # PERF.md, PR 22). Set before torch starts its allocator.
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
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

    t_start = time.perf_counter()
    card = phase_environment(torch)
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dryruns = start_dryruns(dry_dir)
    try:
        return run_phases(torch, card, t_start, dryruns, dry_dir)
    finally:
        stop_processes(dryruns)
        shutil.rmtree(dry_dir, ignore_errors=True)


def run_phases(torch, card, t_start, dryruns, dry_dir) -> int:
    """Every phase after the environment's, phase T's dry-runs already
    running in the background."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import flat_update_dim
    from repro_torch.launch.train import build, parse_args
    from repro_torch.models import build_model
    from repro_torch.strategies import COMPRESSORS
    from repro_torch.utils import tree_leaves

    chip, peaks = card_peaks(torch)
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
    rows.update(phase_frontend_times(torch, peaks))
    rows.update(phase_ssd_times(torch, peaks))

    launches, walls, adversary, population = {}, {}, {}, {}
    built = {}
    for path, argv, op_name, rounds in PATHS:   # A, D-G and B, B100 add
        n, walls[path], per_round, trained = phase_path(
            torch, path, argv, op_name, rounds)
        if path in RPC_PATHS:
            built[path] = trained
        del trained
        launches[op_name] = launches.get(op_name, 0) + n
        if path == "G":
            population["G"] = {"malicious_weight": per_round,
                               "ci_gate": CI_GATE,
                               "wall_ms": walls[path]}
            print(f"path G malicious weight a round: {per_round}; last "
                  f"{per_round[-1]:.5f} (the reference CI's job follows)")
        elif per_round:
            adversary[path] = per_round
    # phase R: paths A-F through the multi-round driver, a CUDA graph of
    # a round replayed, against their eager rounds
    chunked = {path: phase_rounds_per_call(torch, card, path,
                                           built.pop(path), op_name)
               for path, _, op_name, _ in PATHS if path in RPC_PATHS}
    g_noise = build(parse_args(G_NOISE_ARGS))
    chunked["G random_weights"] = phase_rounds_per_call(
        torch, card, "G random_weights", g_noise[:2], "weighted_aggregate")
    del g_noise
    seams = phase_rpc_seams(torch, card)
    # the LM round, after path G: qwen2-0.5b (L, its first rounds again as
    # one chunk of replays), then Mamba2 (M)
    lm = {label: phase_lm(torch, card, label, argv, op_name, overrides,
                          chunk=label == "L")
          for label, argv, op_name, overrides in LM_PHASES}
    # slice 17: the LM round on the population tier, then the vlm's
    lm["LP"] = phase_lm_population(torch, card)
    lm["VR"] = phase_vlm_round(torch, card)
    for label in ("LP", "VR"):
        launches["weighted_aggregate"] += (
            lm[label]["weighted_aggregate_launches"])
    rows.update(phase_fold_times(torch, peaks, lm))
    population["ci"] = phase_population_ci(torch, card)
    launches["weighted_aggregate"] += population["ci"]["launches"]
    # the population phases: memory flat in N, and int8 on the cohort;
    # the largest and int8 again as a chunk of CUDA graph replays
    for n in POP_SIZES:
        population[str(n)] = phase_population(torch, card, n,
                                              chunk=n == POP_SIZES[-1])
    population["int8"] = phase_population(torch, card, POP_INT8_SIZE,
                                          "int8", chunk=True)
    for key in [str(n) for n in POP_SIZES] + ["int8"]:
        row = population[key]
        launches[row["op"]] += row["launches"] + row.get(
            "chunk", {}).get("launches", 0)
    small, large = (population[str(n)]["peak_bytes"] for n in POP_SIZES)
    print(f"population: allocator peak {small / 2**30:.3f} GiB at "
          f"N={POP_SIZES[0]:,}, {large / 2**30:.3f} GiB at "
          f"N={POP_SIZES[1]:,} ({(large - small) / 2**20:.1f} MiB more); "
          f"{card}")
    check(large - small < 2**30,
          f"the peak at N={POP_SIZES[1]:,} exceeds the peak at "
          f"N={POP_SIZES[0]:,} by {(large - small) / 2**30:.3f} GiB")
    # phase P, the pod round: ranks in processes of their own, sharing the
    # card; P3 is the CI job's command above, its cohort over 4 ranks
    free_memory(torch)
    pod = phase_pod(torch, card)
    pod["cli"] = phase_pod_cli(torch, card,
                               population["ci"]["grouped_malicious_weight"])
    for op, n in pod["launches"].items():
        launches[op] = launches.get(op, 0) + n
    # the nccl round's; the CLI runs' rank 0 (each rank launches as many)
    for op, n in pod["cli"]["nccl"]["launches"].items():
        launches[op] = launches.get(op, 0) + n
    for name, *_ in POD_CLI:
        row = pod["cli"][name]
        launches[row["op"]] += row["launches"]
    print(f"phase P took {pod['phase_s'] + pod['cli']['wall_s']:.1f} s "
          f"(P1 {pod['phase_s']:.1f}, P2 and P3 at once "
          f"{pod['cli']['wall_s']:.1f}); {card}")
    comparison = phase_comparison(torch, card)
    repro = phase_reproducible(torch, card)
    serve_counts, serve_out = phase_serve(torch, card)
    launches["flash_attention"] = serve_counts["flash_attention"]
    launches["decode_attention"] = serve_counts["decode_attention"]
    ssm_counts, ssm_out = phase_ssm_serve(torch, card)
    launches["ssd_scan"] = ssm_counts["ssd_scan"]
    # after the serve phases: the durability phase empties this process's
    # allocator cache and starts two CUDA processes
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        durability = phase_durability(torch, card, scratch)
        phase_serve_checkpoint(torch, card, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    # the moe and hybrid families, last: granite and qwen3-moe served at
    # full width and depth, Jamba's period, then the LM round on granite
    moe = {label: phase_moe_serve(torch, card, label, arch, overrides,
                                  n_ref)
           for label, arch, overrides, n_ref in MOE_SERVES}
    moe["N"] = phase_moe_round(torch, card)
    # the encdec and vlm families, last: whisper-base (W) and pixtral-12b
    # (V) served at full width and depth
    t_frontend = time.perf_counter()
    frontend = {label: phase_frontend_serve(torch, card, peaks, label, argv,
                                            n_ref)
                for label, argv, n_ref in FRONTEND_SERVES}
    print(f"phases W and V took {time.perf_counter() - t_frontend:.1f} s, "
          f"the build of each model included ({card})")
    tooling = phase_tooling(torch, card, chip, serve_out, dryruns, dry_dir)

    def entry(name, path_rows, shape, n=None):
        def total(key):    # None where no PyTorch call computes the same
            if any(key not in r for r in path_rows):
                return None
            return sum(r[key] for r in path_rows)
        return {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name] if n is None else n,
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
            "card": card,
            "shapes": rows[name] if n is None else path_rows}

    for path, *_ in PATHS:
        print(f"path {path} round wall ms: "
              f"{[round(t, 3) for t in walls[path]]}, steady (after the "
              f"first) {[round(t, 3) for t in walls[path][1:]]} ({card})")
    print(json.dumps({"kernels": [
        # one round of path A: its 10 leaves in one grouped launch, C=20
        # (paths D-G's, the CI job's and the population phases' launches
        # are counted in: the same call a round, G's and the CI job's at
        # C=32 and the phases' at C=64, timed in its shapes)
        entry("weighted_aggregate", rows["weighted_aggregate"][:1],
              "C=20, one grouped launch a round, M=" + "+".join(
                  str(m) for m in leaves)),
        # one round of path B / C: one launch on the [20, D] matrix (B100's
        # [100, D] launches are counted in and timed in its shapes; so are
        # the int8 population phase's [64, D_pad] payloads)
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
              "bf16"),
        # one call (one layer) of the LM round's cross-test, its testers,
        # clients and eval rows folded into the batch; launches: phase L's
        # and LP's rounds (cross-tests, LP's global columns and global
        # evals)
        entry("flash_attention", rows["flash_attention_fold"],
              "one folded cross-test call: B={}, S=T=64, Hq=14, Hkv=2, "
              "D=64, bf16, causal".format(lm["L"]["folded_shape"][0]),
              n=lm["L"]["launches"] + lm["LP"]["launches"]),
        # phase VR's: pixtral-12b's text round, its 2 testers x 3 clients
        # x 64 rows folded
        entry("flash_attention", rows["flash_attention_fold V"],
              "one folded cross-test call: B={}, S=T=64, Hq=32, Hkv=8, "
              "D=128, bf16, causal".format(lm["VR"]["folded_shape"][0]),
              n=lm["VR"]["launches"]),
        entry("ssd_scan", rows["ssd_scan_fold"],
              "one folded cross-test call: Bt={}, S=64, H=80, P=64, G=1, "
              "N=128, chunk 256, A and D [Bt, H], bf16".format(
                  lm["M"]["folded_shape"][0]), n=lm["M"]["launches"]),
        # phases W and V: one call at each shape; launches: that shape's
        # calls in the measured serve pass (one launch a call)
        *[entry("flash_attention", [row], what,
                n=frontend[label]["flash_calls_by_shape"][str(key)])
          for label, row, what, key in frontend_rows(rows)],
        entry("decode_attention", rows["decode_attention V"],
              "pixtral-12b's decode step, one call (split kernel + merge "
              "kernel): B=8, cache 1569, lengths 1537..1567, Hq=32, Hkv=8, "
              "D=128, bf16", n=frontend["V"]["launches"]["decode_attention"]),
    ]}))
    for label in lm:
        print(f"phase {label} round wall ms: "
              f"{[round(t, 3) for t in lm[label]['wall_ms']]} ({card})")
    print(f"phase N round wall ms: "
          f"{[round(t, 3) for t in moe['N']['wall_ms']]} ({card})")
    for path, row in chunked.items():
        print(f"phase R path {path} a round: eager "
              f"{row['eager_round_ms']:.3f} ms, graphed "
              f"{row['graphed_round_ms']:.3f} ms, device "
              f"{row['device_round_mean_ms']:.3f} ms ({card})")
    print(json.dumps({"lm": lm, "moe": moe, "frontend": frontend,
                      "rounds_per_call": chunked, "rpc_seams_s": seams,
                      "serve": serve_out,
                      "ssm_serve": ssm_out,
                      "reproducible_path_a": repro,
                      "comparison": comparison, "adversary": adversary,
                      "population": population,
                      "pod": pod,
                      "durability": durability,
                      "tooling": tooling}))
    print(f"chip_smoke passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
