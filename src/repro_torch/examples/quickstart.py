"""Quickstart: a few federated rounds of FedTest, the twin of the
reference's ``examples/quickstart.py`` at its sizes (6 users, 1 malicious,
the reduced MNIST CNN, 6 rounds). It prints the weight the server gives
each client a round, so the attacker's collapse shows. Any registered
aggregator / attack pair can be named:

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart krum scaled_update
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

It runs on the card unless given ``--device cpu``, and raises without one.
"""
from __future__ import annotations

import argparse

from repro_torch.config import FedConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import FederatedTrainer
from repro_torch.core.engine import resolve_device
from repro_torch.data import MNIST_LIKE, make_federated_image_dataset
from repro_torch.models import build_model
from repro_torch.strategies import AGGREGATORS, ATTACKS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("aggregator", nargs="?", default="fedtest")
    ap.add_argument("attack", nargs="?", default="random_weights")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"registered aggregators: {', '.join(AGGREGATORS.names())}")
    print(f"registered attacks:     {', '.join(ATTACKS.names())}")

    users, malicious = 6, 1
    cfg = get_config("fedtest-cnn-mnist").replace(cnn_channels=(8, 16, 16),
                                                  cnn_hidden=32)
    model = build_model(cfg)
    print(f"model: {cfg.name} ({model.param_count():,} params), "
          f"{users} users, {malicious} malicious "
          f"({args.attack} attack, {args.aggregator} aggregation) on "
          f"{device}")

    data = make_federated_image_dataset(MNIST_LIKE, users,
                                        num_samples=3000, global_test=400,
                                        device=device)
    fed = FedConfig(num_users=users, num_testers=2,
                    num_malicious=malicious, local_steps=10,
                    score_power=4.0, aggregator=args.aggregator,
                    attack=args.attack,
                    attack_scale=(10.0 if args.attack == "scaled_update"
                                  else 1.0))
    tc = TrainConfig(optimizer="sgd", lr=0.1, schedule="constant",
                     batch_size=16, grad_clip=0.0)
    trainer = FederatedTrainer(model, fed, tc, eval_batch=128,
                               device=device)

    state = trainer.init()
    rows = []       # (round, global accuracy, malicious weight, weights)
    print(f"{'round':>5} {'glob acc':>9} {'mal weight':>11}   weights")
    for r in range(args.rounds):
        state, metrics = trainer.run_round(state, data)
        rows.append((r + 1, trainer.global_accuracy(state, data),
                     float(metrics["malicious_weight"]),
                     metrics["weights"].tolist()))
        w = " ".join(f"{v:.3f}" for v in rows[-1][3])
        print(f"{r + 1:>5} {rows[-1][1]:>9.4f} {rows[-1][2]:>11.5f}   [{w}]")
    print(f"\nClients {trainer.attack.malicious_indices(users)} are "
          "malicious — their aggregation weight should collapse\nwhile "
          "honest clients keep high weight.")
    return rows


if __name__ == "__main__":
    main()
