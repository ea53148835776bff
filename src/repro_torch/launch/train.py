"""Federated training driver of the port (the paper's training kind).

Runs the FedTest round on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
      --dataset cifar_like --aggregator fedtest --users 20 --testers 5 \\
      --malicious 3 --rounds 60

``--device cpu`` runs on the CPU; ``--device cuda`` without a card
raises. The flags are the subset of ``repro.launch.train`` that the
port runs, with its defaults: the main path, plus the update-space
aggregators (``--aggregator trimmed_mean_coord --agg-kwargs
'{"score_gate": 0.5}'``), the compressed exchange (``--compressor
int8``), the server-side baseline (``--aggregator accuracy_based``),
every attack and selector the port registers (``--attack-kwargs``,
``--selector-kwargs``), the cross-testing dispatch
(``--crosstest-impl``) and eval-batch resampling
(``--eval-resample-every``). The port's registries list the names they
refuse, each with its ROADMAP.md item, beside the ones they run, and
the choices take both, so that a refused name says which item ports it.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.config import FedConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config, list_configs
from repro_torch.core import CROSSTEST_IMPLS, FederatedTrainer
from repro_torch.core.engine import resolve_device
from repro_torch.data import (
    CIFAR_LIKE, MNIST_LIKE, make_federated_image_dataset)
from repro_torch.models import build_model
from repro_torch.strategies import (
    AGGREGATORS, ATTACKS, COMPRESSORS, SELECTORS)


def _names(registry):
    """A registry's names, the refused ones included."""
    return sorted(registry.names() + tuple(registry.not_ported))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fedtest-cnn", choices=list_configs())
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (reduce_for_smoke) in f32")
    ap.add_argument("--dataset", default="cifar_like",
                    choices=["cifar_like", "mnist_like"])
    ap.add_argument("--users", type=int, default=20)
    ap.add_argument("--testers", type=int, default=5)
    ap.add_argument("--malicious", type=int, default=0)
    ap.add_argument("--attack", default="random_weights",
                    choices=_names(ATTACKS))
    ap.add_argument("--attack-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the attack ctor, e.g. "
                         '\'{"placement": "first"}\'')
    ap.add_argument("--attack-scale", type=float, default=1.0)
    ap.add_argument("--aggregator", default="fedtest",
                    choices=_names(AGGREGATORS))
    ap.add_argument("--agg-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the aggregator ctor, e.g. "
                         '\'{"trim_fraction": 0.2, "score_gate": 0.5}\'')
    ap.add_argument("--score-power", type=float, default=4.0)
    ap.add_argument("--score-decay", type=float, default=0.5)
    ap.add_argument("--selector", default="rotating",
                    choices=_names(SELECTORS))
    ap.add_argument("--selector-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the selector ctor, e.g. "
                         '\'{"indices": [0, 3]}\' (fixed)')
    ap.add_argument("--crosstest-impl", default="batched",
                    choices=list(CROSSTEST_IMPLS),
                    help="cross-testing dispatch: one batched eval over "
                         "all models, or one eval a (tester, client) pair "
                         "(bitwise equal)")
    ap.add_argument("--eval-resample-every", type=int, default=0,
                    help="redraw each tester's eval rows every N rounds "
                         "(0: the fixed first rows, every round)")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam", "adamw"])
    ap.add_argument("--samples", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--compressor", default="identity",
                    choices=list(COMPRESSORS.names()),
                    help="compressed update exchange: clients send encoded "
                         "updates with per-client error feedback")
    ap.add_argument("--compressor-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the compressor ctor, e.g. "
                         '\'{"k": 0.05}\' (topk) or \'{"chunk": 256}\' '
                         "(int8)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run; 'cuda' raises when no "
                         "card is present")
    ap.add_argument("--out", default="experiments/train")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(trainer, data, model config) for the parsed flags; the data keep
    the server's held-out split (``server_x`` / ``server_y``) that
    ``accuracy_based`` evaluates on."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.dataset == "mnist_like" and args.arch == "fedtest-cnn":
        cfg = get_config("fedtest-cnn-mnist")
    if args.smoke:
        cfg = reduce_for_smoke(cfg).replace(dtype="float32")
    fed = FedConfig(num_users=args.users, num_testers=args.testers,
                    num_malicious=args.malicious, rounds=args.rounds,
                    local_steps=args.local_steps,
                    score_power=args.score_power,
                    score_decay=args.score_decay,
                    aggregator=args.aggregator,
                    aggregator_kwargs=args.agg_kwargs, attack=args.attack,
                    attack_kwargs=args.attack_kwargs,
                    attack_scale=args.attack_scale, selector=args.selector,
                    selector_kwargs=args.selector_kwargs,
                    participation=args.participation,
                    crosstest_impl=args.crosstest_impl,
                    compressor=args.compressor,
                    compressor_kwargs=args.compressor_kwargs,
                    seed=args.seed)
    tc = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                     schedule="constant", batch_size=args.batch,
                     grad_clip=0.0)
    spec = CIFAR_LIKE if args.dataset == "cifar_like" else MNIST_LIKE
    data = make_federated_image_dataset(spec, fed.num_users,
                                        num_samples=args.samples,
                                        seed=fed.seed, device=device)
    trainer = FederatedTrainer(build_model(cfg), fed, tc, device=device,
                               eval_resample_every=args.eval_resample_every)
    return trainer, data, cfg


def main(argv=None):
    args = parse_args(argv)
    trainer, data, cfg = build(args)
    fed = trainer.fed
    t0 = time.time()
    state, history = trainer.run(data, verbose=True)
    history["wall_s"] = time.time() - t0
    history["config"] = {"arch": cfg.name, "dataset": args.dataset,
                         "aggregator": fed.aggregator, "attack": fed.attack,
                         "selector": fed.selector,
                         "compressor": fed.compressor,
                         "crosstest_impl": fed.crosstest_impl,
                         "eval_resample_every":
                             trainer.eval_resample_every,
                         "users": fed.num_users,
                         "testers": fed.num_testers,
                         "malicious": fed.num_malicious,
                         "device": str(trainer.device)}
    os.makedirs(args.out, exist_ok=True)
    tag = (f"{cfg.name}__{args.dataset}__{fed.aggregator}"
           f"__{fed.attack}__m{fed.num_malicious}__torch")
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(history, f, indent=1)
    print(f"final accuracy: {history['global_accuracy'][-1]:.4f} "
          f"({history['wall_s']:.0f}s) -> {args.out}/{tag}.json")


if __name__ == "__main__":
    main()
