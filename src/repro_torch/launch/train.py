"""Federated training driver of the port (the paper's training kind).

Runs the FedTest round on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
      --dataset cifar_like --aggregator fedtest --users 20 --testers 5 \\
      --malicious 3 --rounds 60

  # a named scenario preset (repro_torch.configs.scenarios); a flag
  # passed explicitly overrides that field of the preset:
  PYTHONPATH=src python -m repro_torch.launch.train --scenario \\
      full_collusion_vs_fedtest --fault straggler_deadline --rounds 10

  # durable: a checkpoint every 2 rounds and at the end; SIGTERM stops at
  # the next round boundary and saves; --resume continues to --rounds
  PYTHONPATH=src python -m repro_torch.launch.train --ckpt-dir ckpt \\
      --ckpt-every 2 --rounds 10
  PYTHONPATH=src python -m repro_torch.launch.train --ckpt-dir ckpt \\
      --resume --rounds 20

  # the population tier (DESIGN.md §11): N clients, a cohort of C
  # sampled a round (participation C/N), testers recruited from it
  PYTHONPATH=src python -m repro_torch.launch.train --population 4096 \\
      --cohort 32 --testers 8 --testers-from-cohort --rounds 12

  # an LM round (the dense, moe, ssm, hybrid or vlm family) on synthetic
  # topic-skewed token shards; local training differentiates the
  # kernels' twins, cross-testing runs flash_attention / ssd_scan
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --dataset lm --users 4 --testers 2 --malicious 1 --local-steps 8 \\
      --batch 16 --optimizer adamw --lr 2e-3 --rounds 3

  # chunks of 4 rounds: on the card one CUDA graph of a round, captured
  # once and replayed 4 times with no read to the host between rounds;
  # the global accuracy is read at every chunk boundary
  PYTHONPATH=src python -m repro_torch.launch.train --rounds-per-call 4 \\
      --rounds 10

  # the population tier in chunks of 4 rounds (one CUDA graph of its
  # round: the cohort plan, the attack's slots and the keyed noise stay
  # on the card), and its LM round, the cohort of 4 sampled from 256
  PYTHONPATH=src python -m repro_torch.launch.train --population 4096 \\
      --cohort 32 --testers 8 --testers-from-cohort --rounds-per-call 4 \\
      --attack random_weights --rounds 12
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --dataset lm --population 256 --cohort 4 --testers 2 \\
      --testers-from-cohort --malicious 64 --local-steps 8 --batch 16 \\
      --optimizer adamw --lr 2e-3 --rounds 3

  # the vlm's round on its text (the reference batches tokens alone, so
  # patch_proj gets a zero gradient; reduced here: 12B params a client
  # do not fit one card), and the CI's suppression gate
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --arch pixtral-12b --dataset lm --users 3 --testers 2 --malicious 1 \\
      --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --dataset mnist_like \\
      --fault dropout --malicious 2 --rounds 6 --assert-malicious-below 0.2

``--device cpu`` runs on the CPU (add ``--smoke`` for the reduced
configs); ``--device cuda`` without a card raises. The flags are
``repro.launch.train``'s, with its defaults, plus ``--device`` and
``--participation``. ``--population`` runs ``PopulationTrainer`` over the
dense dataset (images or LM tokens) through ``DensePopulationData``. The
encdec family has no LM round (the reference's fails).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (
    LM_FAMILIES, ROUND_LM_FAMILIES, FedConfig, TrainConfig,
    reduce_for_smoke)
from repro_torch.configs import (
    get_config, get_scenario, list_configs, list_scenarios,
    scenario_for_population)
from repro_torch.core import CROSSTEST_IMPLS, FederatedTrainer
from repro_torch.core.engine import PopulationTrainer, resolve_device
from repro_torch.data import (
    CIFAR_LIKE, MNIST_LIKE, DensePopulationData, FederatedDataset,
    build_client_arrays, make_federated_image_dataset, make_token_stream,
    split_client_holdout)
from repro_torch.models import build_model
from repro_torch.strategies import (
    AGGREGATORS, ATTACKS, COALITIONS, COMPRESSORS, FAULTS, SELECTORS)

def make_lm_federated_dataset(vocab: int, num_users: int, seq_len: int = 64,
                              seqs_per_user: int = 64, seed: int = 0,
                              skew: float = 0.7, *, device
                              ) -> FederatedDataset:
    """Non-IID LM data, the reference's builder: client i holds ``skew``
    of its sequences from its own topic and the rest from a uniform topic
    mix; a quarter of each client's sequences held out for its testers;
    512 global and 256 server sequences after the clients'. Made in numpy
    as there, so bitwise the reference's, and moved to ``device`` once."""
    rng = np.random.default_rng(seed)
    toks, topics = make_token_stream(vocab, num_users * seqs_per_user * 2,
                                     seq_len + 1, num_topics=num_users,
                                     seed=seed)
    x = toks[:, :-1]
    y = toks[:, 1:]
    n = num_users * seqs_per_user
    by_topic = [list(np.flatnonzero(topics[:n] == t))
                for t in range(num_users)]
    pool = list(range(n))
    rng.shuffle(pool)
    parts = []
    used = set()
    for u in range(num_users):
        own = [i for i in by_topic[u % num_users] if i not in used]
        sel = own[:int(seqs_per_user * skew)]
        used.update(sel)
        fill = [i for i in pool if i not in used][:seqs_per_user - len(sel)]
        used.update(fill)
        parts.append(np.array(sel + fill, dtype=np.int64))
    xs, ys, counts = build_client_arrays(x[:n], y[:n], parts)
    train, test = split_client_holdout(xs, ys, counts, frac=0.25,
                                       device=device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return FederatedDataset(train=train, test=test,
                            global_x=dev(x[n:n + 512]),
                            global_y=dev(y[n:n + 512]),
                            server_x=dev(x[n + 512:n + 768]),
                            server_y=dev(y[n + 512:n + 768]))


# FedConfig fields the command line leaves unset take these (the flags
# default to None, so --scenario can tell a flag passed from one not)
_FED_CLI_DEFAULTS = dict(
    num_users=20, num_testers=5, num_malicious=0, rounds=40,
    local_steps=10, score_power=4.0, score_decay=0.5,
    aggregator="fedtest", aggregator_kwargs={},
    attack="random_weights", attack_kwargs={}, attack_scale=1.0,
    selector="rotating", selector_kwargs={},
    coalition="none", coalition_kwargs={}, coalition_size=0,
    fault="none", fault_kwargs={}, fault_rate=0.1,
    compressor="identity", compressor_kwargs={}, seed=0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fedtest-cnn", choices=list_configs())
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (reduce_for_smoke) in f32")
    ap.add_argument("--dataset", default="cifar_like",
                    choices=["cifar_like", "mnist_like", "lm"],
                    help="synthetic images, or (lm) topic-skewed token "
                         "shards for the dense and ssm archs")
    ap.add_argument("--scenario", default=None, choices=list_scenarios(),
                    help="named FedConfig preset; flags passed explicitly "
                         "override its fields")
    ap.add_argument("--users", type=int, default=None)
    ap.add_argument("--population", type=int, default=None,
                    help="run the population tier (DESIGN.md §11) over "
                         "this many clients: a round computes only on the "
                         "sampled cohort (--cohort), scores stay dense "
                         "[N]. Scenario presets are refit via "
                         "scenario_for_population")
    ap.add_argument("--cohort", type=int, default=None,
                    help="cohort slot capacity C for --population "
                         "(default: the whole population); the Bernoulli "
                         "sampling rate is refit to C/N. Errors when "
                         "C > N")
    ap.add_argument("--testers-from-cohort", action="store_true",
                    help="population tier: recruit the round's testing "
                         "committee from the sampled cohort (at C << N a "
                         "population-wide tester almost never "
                         "participates and scoring degenerates)")
    ap.add_argument("--testers", type=int, default=None)
    ap.add_argument("--malicious", type=int, default=None)
    ap.add_argument("--attack", default=None, choices=list(ATTACKS.names()))
    ap.add_argument("--attack-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the attack ctor, e.g. "
                         '\'{"placement": "first"}\'')
    ap.add_argument("--attack-scale", type=float, default=None)
    ap.add_argument("--aggregator", default=None,
                    choices=list(AGGREGATORS.names()))
    ap.add_argument("--agg-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the aggregator ctor, e.g. "
                         '\'{"trim_fraction": 0.2, "score_gate": 0.5}\'')
    ap.add_argument("--score-power", type=float, default=None)
    ap.add_argument("--score-decay", type=float, default=None)
    ap.add_argument("--selector", default=None,
                    choices=list(SELECTORS.names()))
    ap.add_argument("--selector-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the selector ctor, e.g. "
                         '\'{"indices": [0, 3]}\' (fixed)')
    ap.add_argument("--coalition", default=None,
                    choices=list(COALITIONS.names()),
                    help="coordinated multi-client adversary "
                         "(DESIGN.md §7); size via --coalition-size")
    ap.add_argument("--coalition-size", type=int, default=None,
                    help="number of coordinated members (placement via "
                         "--coalition-kwargs)")
    ap.add_argument("--coalition-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the coalition ctor, e.g. "
                         '\'{"boost_to": 0.9, "deflate_top": 2}\'')
    ap.add_argument("--fault", default=None, choices=list(FAULTS.names()),
                    help="client failures injected after tester selection "
                         "(DESIGN.md §9)")
    ap.add_argument("--fault-rate", type=float, default=None,
                    help="per-round drop probability offered to the fault "
                         "model (dropout)")
    ap.add_argument("--fault-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the fault ctor, e.g. "
                         '\'{"placement": "first", "size": 2}\'')
    ap.add_argument("--crosstest-impl", default=None,
                    choices=list(CROSSTEST_IMPLS),
                    help="cross-testing dispatch: one batched eval over "
                         "all models, or one eval a (tester, client) pair "
                         "(bitwise equal)")
    ap.add_argument("--eval-resample-every", type=int, default=0,
                    help="redraw each tester's eval rows every N rounds "
                         "(0: the fixed first rows, every round)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--rounds-per-call", type=int, default=1,
                    help=">1 routes steady-state training through the "
                         "multi-round driver (one CUDA graph of a round, "
                         "replayed this many times a call, on the card; a "
                         "loop on the CPU); global accuracy is evaluated "
                         "at chunk boundaries")
    ap.add_argument("--local-steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam", "adamw"])
    ap.add_argument("--samples", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--participation", type=float, default=None)
    ap.add_argument("--compressor", default=None,
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (the final state is always "
                         "saved there; periodic saves via --ckpt-every)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the whole round state every N completed "
                         "rounds (0: the final save only)")
    ap.add_argument("--assert-malicious-below", type=float, default=None,
                    help="exit non-zero unless the final round's "
                         "malicious_weight is below this bar (the CI "
                         "dropout-suppression gate)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint from --ckpt-dir "
                         "and continue to --rounds; refuses another run's "
                         "manifest")
    return ap.parse_args(argv)


def fed_config(args: argparse.Namespace) -> FedConfig:
    """The run's FedConfig: the ``--scenario`` preset (else the CLI
    defaults), with every flag passed explicitly in place of its field."""
    passed = dict(num_users=args.users, num_testers=args.testers,
                  num_malicious=args.malicious, rounds=args.rounds,
                  local_steps=args.local_steps,
                  score_power=args.score_power,
                  score_decay=args.score_decay,
                  aggregator=args.aggregator,
                  aggregator_kwargs=args.agg_kwargs,
                  attack=args.attack, attack_kwargs=args.attack_kwargs,
                  attack_scale=args.attack_scale, selector=args.selector,
                  selector_kwargs=args.selector_kwargs,
                  coalition=args.coalition,
                  coalition_size=args.coalition_size,
                  coalition_kwargs=args.coalition_kwargs,
                  fault=args.fault, fault_kwargs=args.fault_kwargs,
                  fault_rate=args.fault_rate,
                  participation=args.participation,
                  compressor=args.compressor,
                  compressor_kwargs=args.compressor_kwargs,
                  crosstest_impl=args.crosstest_impl, seed=args.seed)
    passed = {f: v for f, v in passed.items() if v is not None}
    if args.cohort is not None and args.population is None:
        raise SystemExit("--cohort requires --population")
    if args.population is not None:
        # the population tier: N from --population, the sampling rate
        # from the cohort budget
        if args.users is not None:
            raise SystemExit("--population replaces --users; pass one")
        if args.eval_resample_every:
            raise SystemExit("--eval-resample-every is a dense-driver "
                             "feature; the population tier gathers "
                             "tester rows directly")
        cohort = args.cohort or args.population
        if args.scenario:
            # scenario_for_population refuses C > N and refits the
            # coalition's members inside the population
            fed = scenario_for_population(args.scenario, args.population,
                                          cohort)
            return dataclasses.replace(fed, **passed)
        base = {**_FED_CLI_DEFAULTS, **passed,
                "num_users": args.population, "cohort": cohort}
        if cohort < args.population:
            base["participation"] = cohort / args.population
        return FedConfig(**base)
    if args.scenario:
        return dataclasses.replace(get_scenario(args.scenario), **passed)
    return FedConfig(**{**_FED_CLI_DEFAULTS, **passed})


def build(args: argparse.Namespace, **overrides):
    """(trainer, data, model config) for the parsed flags; the data keep
    the server's held-out split (``server_x`` / ``server_y``) that
    ``accuracy_based`` evaluates on. With ``--population`` the trainer is
    a ``PopulationTrainer`` and the data its ``DensePopulationData``
    view. ``overrides`` replace fields of the arch's config (a cut of its
    depth) before ``--smoke``, as ``launch.serve.build``'s do."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.dataset == "mnist_like" and args.arch == "fedtest-cnn":
        cfg = get_config("fedtest-cnn-mnist")
    if overrides:
        cfg = cfg.replace(**overrides)
    if args.smoke:
        cfg = reduce_for_smoke(cfg).replace(dtype="float32")
    lm = cfg.family in LM_FAMILIES
    if lm and cfg.family not in ROUND_LM_FAMILIES:
        raise SystemExit(
            f"--arch {args.arch} ({cfg.family}) has no LM round (ROADMAP.md "
            "queue 1 item 16's leftovers): the reference's round fails for "
            "encdec: its forward_train reads batch['frames'], which "
            "RoundProgram.batchify never makes (it batches tokens alone); "
            "serve it with repro_torch.launch.serve")
    if lm != (args.dataset == "lm"):
        raise SystemExit(f"--arch {args.arch} ({cfg.family}) and --dataset "
                         f"{args.dataset} do not go together: the LMs take "
                         "--dataset lm, the classifiers an image dataset")
    fed = fed_config(args)
    tc = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                     schedule="constant", batch_size=args.batch,
                     grad_clip=0.0)
    if lm:
        data = make_lm_federated_dataset(cfg.vocab_size, fed.num_users,
                                         seed=fed.seed, device=device)
    else:
        spec = CIFAR_LIKE if args.dataset == "cifar_like" else MNIST_LIKE
        data = make_federated_image_dataset(spec, fed.num_users,
                                            num_samples=args.samples,
                                            seed=fed.seed, device=device)
    if args.population is not None:
        trainer = PopulationTrainer(
            build_model(cfg), fed, tc, device=device,
            rounds_per_call=args.rounds_per_call,
            testers_from_cohort=args.testers_from_cohort)
        return trainer, DensePopulationData(data), cfg
    trainer = FederatedTrainer(build_model(cfg), fed, tc, device=device,
                               eval_resample_every=args.eval_resample_every,
                               rounds_per_call=args.rounds_per_call)
    return trainer, data, cfg


def main(argv=None):
    args = parse_args(argv)
    trainer, data, cfg = build(args)
    fed = trainer.fed
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
    init_state = None
    if args.resume:
        if mgr is None:
            raise SystemExit("--resume requires --ckpt-dir")
        init_state, at = trainer.restore_checkpoint(mgr)
        print(f"resuming from round {at} in {args.ckpt_dir}")

    # SIGTERM stops the loop at the next round boundary; the state run()
    # returns is then saved below like any other, so a soft kill loses no
    # completed round
    stop = {"flag": False}

    def on_sigterm(signum, frame):
        stop["flag"] = True
        print("SIGTERM: finishing the current round, then checkpointing",
              flush=True)

    prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    t0 = time.time()
    try:
        state, history = trainer.run(data, verbose=True, state=init_state,
                                     ckpt=mgr,
                                     should_stop=lambda: stop["flag"])
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
    completed = state.round_idx     # not fed.rounds: SIGTERM, or resumed
    if mgr is not None:
        trainer.save_checkpoint(mgr, state, step=completed)
        print(f"checkpoint saved at round {completed} -> {args.ckpt_dir}")
    if stop["flag"]:
        raise SystemExit(f"interrupted at round {completed} (state saved)")

    history["wall_s"] = time.time() - t0
    history["config"] = {"arch": cfg.name, "dataset": args.dataset,
                         "aggregator": fed.aggregator, "attack": fed.attack,
                         "selector": fed.selector,
                         "coalition": fed.coalition,
                         "coalition_size": fed.coalition_size,
                         "fault": fed.fault, "fault_rate": fed.fault_rate,
                         "compressor": fed.compressor,
                         "scenario": args.scenario,
                         "crosstest_impl": fed.crosstest_impl,
                         "eval_resample_every":
                             trainer.eval_resample_every,
                         "rounds_per_call": trainer.rounds_per_call,
                         "users": fed.num_users,
                         "testers": fed.num_testers,
                         "malicious": fed.num_malicious,
                         "cohort": fed.cohort,
                         "testers_from_cohort": args.testers_from_cohort,
                         "resumed": bool(args.resume),
                         "device": str(trainer.device)}
    os.makedirs(args.out, exist_ok=True)
    tag = (f"{cfg.name}__{args.dataset}__{fed.aggregator}"
           f"__{fed.attack}__m{fed.num_malicious}__torch")
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(history, f, indent=1)
    if history["global_accuracy"]:
        print(f"final accuracy: {history['global_accuracy'][-1]:.4f} "
              f"({history['wall_s']:.0f}s) -> {args.out}/{tag}.json")
    else:   # resumed at or past the target: nothing ran
        print(f"no rounds to run (already at {completed}/{fed.rounds})")

    if args.assert_malicious_below is not None:
        final = history["malicious_weight"][-1]
        if not final < args.assert_malicious_below:
            raise SystemExit(
                f"malicious_weight={final:.4f} did not drop below "
                f"{args.assert_malicious_below} after {completed} "
                "rounds")
        print(f"assert ok: malicious_weight={final:.4f} < "
              f"{args.assert_malicious_below}")


if __name__ == "__main__":
    main()
