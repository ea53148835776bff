"""The paper's comparison (Figs. 4 & 5), the twin of the reference's
``examples/fedtest_cifar.py``: FedTest against FedAvg and the
accuracy-based scheme on the same CIFAR-like or MNIST-like shards, with
malicious users. A CPU-sized run by default; ``--full`` runs the paper's
scale (20 users, the full CNN, 20,000 samples).

  PYTHONPATH=src python -m repro_torch.examples.fedtest_cifar --rounds 12
  PYTHONPATH=src python -m repro_torch.examples.fedtest_cifar \\
      --dataset mnist_like --malicious 4 --full

It runs on the card unless given ``--device cpu``, and raises without one.
:func:`run_curve` and :func:`rounds_to_reach` are the port's own copies of
the reference benchmark's (``benchmarks/bench_convergence.py``).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.config import FedConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import FederatedTrainer
from repro_torch.core.engine import resolve_device
from repro_torch.data import (
    CIFAR_LIKE, MNIST_LIKE, make_federated_image_dataset)
from repro_torch.models import build_model

AGGREGATORS = ("fedtest", "fedavg", "accuracy_based")


def _setup(dataset: str, fast: bool, device):
    if dataset == "cifar_like":
        spec, arch = CIFAR_LIKE, "fedtest-cnn"
    else:
        spec, arch = MNIST_LIKE, "fedtest-cnn-mnist"
    cfg = get_config(arch)
    if fast:
        cfg = cfg.replace(cnn_channels=(8, 16, 16), cnn_hidden=32)
    users = 8 if fast else 20
    samples = 4000 if fast else 20000
    data = make_federated_image_dataset(spec, users, num_samples=samples,
                                        global_test=500 if fast else 2000,
                                        seed=0, device=device)
    return cfg, users, data


def run_curve(dataset: str, aggregator: str, malicious: int, rounds: int,
              fast: bool = True, device="cuda"):
    """One convergence curve: ``rounds`` rounds of ``aggregator`` against
    ``malicious`` ``random_weights`` attackers at scale 4, the global
    accuracy measured after each; returns the trainer's history dict."""
    device = resolve_device(device)
    cfg, users, data = _setup(dataset, fast, device)
    model = build_model(cfg)
    fed = FedConfig(num_users=users, num_testers=max(users // 4, 2),
                    num_malicious=malicious, rounds=rounds, local_steps=10,
                    attack="random_weights", attack_scale=4.0,
                    aggregator=aggregator)
    tc = TrainConfig(optimizer="sgd", lr=0.1, schedule="constant",
                     batch_size=16 if fast else 32, grad_clip=0.0)
    trainer = FederatedTrainer(model, fed, tc,
                               eval_batch=128 if fast else 256,
                               device=device)
    t0 = time.time()
    _, hist = trainer.run(data)
    hist["wall_s"] = time.time() - t0
    hist["dataset"] = dataset
    hist["aggregator"] = aggregator
    hist["malicious"] = malicious
    return hist


def rounds_to_reach(hist, target: float):
    for r, a in zip(hist["round"], hist["global_accuracy"]):
        if a >= target:
            return r
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cifar_like",
                    choices=["cifar_like", "mnist_like"])
    ap.add_argument("--malicious", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale: 20 users, full CNN")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    curves = {}
    for agg in AGGREGATORS:
        print(f"=== {agg} ({args.dataset}, {args.malicious} malicious) ===")
        hist = run_curve(args.dataset, agg, args.malicious, args.rounds,
                         fast=not args.full, device=args.device)
        curves[agg] = hist
        for r, a in zip(hist["round"], hist["global_accuracy"]):
            bar = "#" * int(a * 50)
            print(f"  round {r:3d}  {a:.4f} {bar}")

    print("\nfinal accuracies:")
    for agg, hist in curves.items():
        tgt = rounds_to_reach(hist, 0.6)
        print(f"  {agg:16s} {hist['global_accuracy'][-1]:.4f}"
              f"   rounds_to_0.6={tgt}")
    return curves


if __name__ == "__main__":
    main()
