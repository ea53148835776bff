"""The pod's federated training driver (counterpart of
``repro/launch/federated.py``): FedTest with one client a rank of a
``torch.distributed`` group, on the ring or the all-gather exchange.

This is the deployment path (``launch/train.py`` is the single-device
simulation); both drive the same ``RoundProgram``. The command starts
``--clients`` ranks itself (the ``spawn`` start method, a ``file://``
rendezvous in a temporary directory), or runs as one rank where
``RANK`` and ``WORLD_SIZE`` are set (``torchrun``). Rank 0 prints the
round lines and writes ``{dataset}__{exchange}.json`` with the
reference's keys.

  # four ranks on the CPU (gloo):
  PYTHONPATH=src python -m repro_torch.launch.federated --device cpu \\
      --clients 4 --rounds 2 --attack sign_flip --malicious 1

  # four ranks sharing one card, the exchange staged through host memory:
  PYTHONPATH=src python -m repro_torch.launch.federated --clients 4 \\
      --dist-backend gloo --exchange allgather --participation 0.75

  # one card a rank (nccl, the default on the card):
  PYTHONPATH=src python -m repro_torch.launch.federated --clients 4

  # the population tier, its cohort of 32 sharded over the 4 ranks:
  PYTHONPATH=src python -m repro_torch.launch.federated --device cpu \\
      --clients 4 --population 4096 --cohort 32 --rounds 12 \\
      --attack sign_flip --malicious 820 --testers 8 \\
      --testers-from-cohort --local-steps 4 --batch 8

The flags and their defaults are the reference's, plus ``--device``
(``cuda`` by default; it raises without a card) and ``--dist-backend``
(:func:`~repro_torch.launch.mesh.resolve_dist_backend`: ``gloo`` on the
CPU; ``nccl``, one card a rank, by default on the card, refused with
fewer cards than ranks; ``gloo`` on the card stages every collective
through host memory, which the first line names). Every rank draws the
round from the same generator, seeded from ``--seed``, so the run is
reproducible bitwise and ring and allgather give the same state.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.launch.mesh import (
    DIST_BACKENDS, init_rank, resolve_dist_backend, run_ranks)

# FedConfig fields the CLI leaves unset fall back to these (argparse
# defaults are None so --scenario can tell "explicitly passed" apart)
_FED_CLI_DEFAULTS = dict(
    num_malicious=0, attack="none", attack_kwargs={}, attack_scale=1.0,
    aggregator="fedtest", selector="rotating", participation=1.0,
    coalition="none", coalition_kwargs={}, coalition_size=0,
    fault="none", fault_kwargs={}, fault_rate=0.1,
    local_steps=6)
# the reference's reduced CNN for the pod
POD_CNN = dict(cnn_channels=(8, 16, 16), cnn_hidden=32)
EVAL_ROWS = 64          # each tester's test rows
GLOBAL_ROWS = 400       # the global accuracy's rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8,
                    help="ranks of the group, one client each")
    ap.add_argument("--population", type=int, default=None,
                    help="run the population tier (DESIGN.md §11): N "
                         "simulated clients, per-round compute on the "
                         "sampled cohort only, the [C] cohort axis "
                         "sharded across the --clients ranks")
    ap.add_argument("--cohort", type=int, default=None,
                    help="cohort slot capacity C for --population; must "
                         "divide evenly across --clients ranks. The "
                         "Bernoulli sampling rate is refit to C/N. "
                         "Errors loudly when C > N")
    ap.add_argument("--testers-from-cohort", action="store_true",
                    help="population tier: recruit the round's testing "
                         "committee from the sampled cohort instead of "
                         "the whole population (at C << N a "
                         "population-wide tester almost never "
                         "participates, so every report row is masked "
                         "and scoring degenerates; DESIGN.md §11)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--exchange", default="ring",
                    choices=["ring", "allgather"],
                    help="cross-testing model exchange: the ring's N - 1 "
                         "hops or every model gathered at once")
    ap.add_argument("--scenario", default=None,
                    help="named FedConfig preset (repro_torch.configs."
                         "scenarios), refitted to --clients ranks; "
                         "explicit flags override preset fields")
    ap.add_argument("--aggregator", default=None,
                    help="repro_torch.strategies.AGGREGATORS name (krum / "
                         "trimmed_mean / median gather the flat updates; "
                         "trimmed_mean_coord / median_coord additionally "
                         "combine() them per coordinate on the gathered "
                         "[N, D] matrix, robust_combine on the card)")
    ap.add_argument("--attack", default=None,
                    help="repro_torch.strategies.ATTACKS name; corruption "
                         "runs on each rank before the model exchange")
    ap.add_argument("--malicious", type=int, default=None,
                    help="number of malicious clients (placement via "
                         "--attack-kwargs)")
    ap.add_argument("--attack-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the attack ctor, e.g. "
                         '\'{"placement": "first"}\'')
    ap.add_argument("--attack-scale", type=float, default=None)
    ap.add_argument("--participation", type=float, default=None,
                    help="per-round Bernoulli client-sampling fraction "
                         "R/N; non-sampled clients train nothing, report "
                         "nothing and get zero aggregation weight")
    ap.add_argument("--selector", default=None,
                    help="repro_torch.strategies.SELECTORS name for the "
                         "per-round tester mask")
    ap.add_argument("--coalition", default=None,
                    help="repro_torch.strategies.COALITIONS name "
                         "(DESIGN.md §7): coordinated members mount a "
                         "model attack and/or rewrite their tester rows "
                         "of the replicated accuracy matrix")
    ap.add_argument("--coalition-size", type=int, default=None,
                    help="number of coordinated members")
    ap.add_argument("--coalition-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the coalition ctor, e.g. "
                         '\'{"boost_to": 0.9}\'')
    ap.add_argument("--fault", default=None,
                    help="repro_torch.strategies.FAULTS name (DESIGN.md "
                         "§9): availability fault ANDed into the "
                         "participation mask after tester selection")
    ap.add_argument("--fault-rate", type=float, default=None,
                    help="per-round drop probability for the fault model")
    ap.add_argument("--fault-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the fault ctor, e.g. "
                         '\'{"deadline": 2.0}\'')
    ap.add_argument("--compressor", default=None,
                    help="repro_torch.strategies.COMPRESSORS name "
                         "(DESIGN.md §12): clients transmit encoded "
                         "deltas with per-client error feedback instead "
                         "of dense models; the round carries a "
                         "replicated [N, D] feedback buffer")
    ap.add_argument("--compressor-kwargs", default=None, type=json.loads,
                    help="JSON kwargs for the compressor ctor, e.g. "
                         '\'{"k": 0.05}\' (topk) or \'{"chunk": 256}\' '
                         "(int8)")
    ap.add_argument("--assert-malicious-below", type=float, default=None,
                    help="exit non-zero unless the final round's "
                         "malicious_weight is below this bar (the CI "
                         "coalition smoke gate)")
    ap.add_argument("--testers", type=int, default=None,
                    help="K testers per round (default: all clients)")
    ap.add_argument("--crosstest-impl", default=None,
                    choices=["batched", "reference"],
                    help="cross-testing dispatch: the overlapped ring hop "
                         "and the vmapped eval of the gathered stack, or "
                         "the reference schedule (bit-identical)")
    ap.add_argument("--dataset", default="mnist_like",
                    choices=["mnist_like", "cifar_like"])
    ap.add_argument("--min-classes", type=int, default=None,
                    help="mildest shard skew: every client holds at "
                         "least this many classes")
    ap.add_argument("--out", default="experiments/federated_pod")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the ranks' device type; 'cuda' raises when no "
                         "card is present")
    ap.add_argument("--dist-backend", default=None, choices=DIST_BACKENDS,
                    help="the group's backend: gloo on the CPU; on the "
                         "card nccl (default, one card a rank) or gloo "
                         "(ranks share the card, collectives staged "
                         "through host memory)")
    return ap.parse_args(argv)


def _passed(args, *names):
    """The FedConfig fields passed explicitly on the command line."""
    passed = dict(num_testers=args.testers, num_malicious=args.malicious,
                  local_steps=args.local_steps,
                  aggregator=args.aggregator,
                  attack=args.attack, attack_kwargs=args.attack_kwargs,
                  attack_scale=args.attack_scale,
                  selector=args.selector,
                  coalition=args.coalition,
                  coalition_size=args.coalition_size,
                  coalition_kwargs=args.coalition_kwargs,
                  fault=args.fault, fault_kwargs=args.fault_kwargs,
                  fault_rate=args.fault_rate,
                  compressor=args.compressor,
                  compressor_kwargs=args.compressor_kwargs,
                  crosstest_impl=args.crosstest_impl,
                  seed=args.seed)
    passed.update({n: getattr(args, n) for n in names})
    return {f: v for f, v in passed.items() if v is not None}


def pod_fed_config(args):
    """The pod run's FedConfig: the ``--scenario`` preset refit to
    ``--clients`` (else the CLI defaults), flags passed in place of its
    fields."""
    from repro_torch.config import FedConfig
    from repro_torch.configs import scenario_for_pod
    passed = _passed(args, "participation")
    if args.scenario:
        return dataclasses.replace(scenario_for_pod(args.scenario,
                                                    args.clients), **passed)
    defaults = dict(_FED_CLI_DEFAULTS, num_testers=args.clients)
    return FedConfig(num_users=args.clients, **{**defaults, **passed})


def population_fed_config(args):
    """The population run's FedConfig, as the reference's
    ``_run_population`` builds it."""
    from repro_torch.config import FedConfig
    from repro_torch.configs import scenario_for_population
    passed = _passed(args, "rounds")
    if args.scenario:
        fed = scenario_for_population(args.scenario, args.population,
                                      args.cohort)
        return dataclasses.replace(fed, **passed)
    base = dict(_FED_CLI_DEFAULTS, num_testers=min(8, args.cohort))
    base.update(passed)
    base.update(num_users=args.population, cohort=args.cohort,
                participation=(args.cohort / args.population
                               if args.cohort < args.population
                               else base.get("participation", 1.0)))
    return FedConfig(**base)


def _model_and_train(args):
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    arch = ("fedtest-cnn-mnist" if args.dataset == "mnist_like"
            else "fedtest-cnn")
    model = build_model(get_config(arch).replace(**POD_CNN))
    tc = TrainConfig(optimizer="sgd", lr=args.lr, schedule="constant",
                     batch_size=args.batch, grad_clip=0.0)
    return model, tc


def build_pod(args, group):
    """(trainer, data) of the pod run on ``group``: the reference's
    reduced CNN, ``--clients`` x 250 samples with 400 global test rows,
    and a :class:`~repro_torch.core.engine.PodTrainer` on the
    ``--exchange`` backend."""
    from repro_torch.core.engine import PodTrainer
    from repro_torch.data import (
        CIFAR_LIKE, MNIST_LIKE, make_federated_image_dataset)
    fed = pod_fed_config(args)
    model, tc = _model_and_train(args)
    spec = MNIST_LIKE if args.dataset == "mnist_like" else CIFAR_LIKE
    pkw = ({"min_classes": args.min_classes,
            "max_classes": spec.num_classes}
           if args.min_classes is not None else None)
    n = args.clients
    data = make_federated_image_dataset(
        spec, n, num_samples=n * 250, global_test=GLOBAL_ROWS,
        seed=args.seed, partition_kwargs=pkw, device=group.device)
    trainer = PodTrainer(model, fed, tc, eval_batch=EVAL_ROWS, group=group,
                         exchange=args.exchange)
    return trainer, data


def run_pod(group, args):
    """One rank's pod run; rank 0 prints the round lines and returns the
    history (with the reference's keys), the others None."""
    trainer, data = build_pod(args, group)
    fed, lead = trainer.fed, group.rank == 0
    if lead:
        print(f"pod: {group.world_size} ranks on {group.device.type}, "
              f"transport {group.transport}, {args.exchange} exchange",
              flush=True)
    state = trainer.init(args.seed)
    history = {"round": [], "acc": [], "local_loss": [],
               "malicious_weight": [], "participation_rate": [],
               "dropped_fraction": []}
    t0 = time.time()
    for r in range(args.rounds):
        state, metrics = trainer.run_round(state, data)
        if not lead:
            continue
        acc = float(trainer.program.eval_fn(state.global_params,
                                            data.global_x[:GLOBAL_ROWS],
                                            data.global_y[:GLOBAL_ROWS]))
        history["round"].append(r + 1)
        history["acc"].append(acc)
        for k in ("local_loss", "malicious_weight", "participation_rate",
                  "dropped_fraction"):
            history[k].append(float(metrics[k]))
        print(f"round {r + 1}: global_acc={acc:.4f} "
              f"local_loss={history['local_loss'][-1]:.4f} "
              f"mal_w={history['malicious_weight'][-1]:.4f} "
              f"part={history['participation_rate'][-1]:.2f} "
              f"drop={history['dropped_fraction'][-1]:.2f} "
              f"({args.exchange} exchange)", flush=True)
    if not lead:
        return None
    history["wall_s"] = time.time() - t0
    history["config"] = {"clients": group.world_size,
                         "aggregator": fed.aggregator,
                         "attack": fed.attack,
                         "malicious": fed.num_malicious,
                         "attack_scale": fed.attack_scale,
                         "participation": fed.participation,
                         "coalition": fed.coalition,
                         "coalition_size": fed.coalition_size,
                         "fault": fed.fault, "fault_rate": fed.fault_rate,
                         "compressor": fed.compressor,
                         "scenario": args.scenario,
                         "exchange": args.exchange,
                         "transport": group.transport}
    _write(args, f"{args.dataset}__{args.exchange}.json", history)
    return history


def run_population(group, args):
    """One rank's population run, the cohort's slots sharded over the
    group; rank 0 prints the rounds and returns the history."""
    from repro_torch.core.engine import PopulationTrainer
    from repro_torch.data import (
        CIFAR_LIKE, MNIST_LIKE, make_synthetic_population)
    fed = population_fed_config(args)
    model, tc = _model_and_train(args)
    spec = MNIST_LIKE if args.dataset == "mnist_like" else CIFAR_LIKE
    # derive-on-gather population data: construction cost independent
    # of N, only the cohort's shards ever exist on the device
    data = make_synthetic_population(
        args.population, per_client=max(args.batch * 4, 64),
        image_size=spec.image_size, channels=spec.channels,
        num_classes=spec.num_classes, noise=spec.noise, seed=args.seed,
        device=group.device)
    trainer = PopulationTrainer(
        model, fed, tc, eval_batch=EVAL_ROWS,
        testers_from_cohort=args.testers_from_cohort, group=group)
    lead = group.rank == 0
    if lead:
        print(f"population: {args.population} clients, cohort "
              f"{args.cohort} over {group.world_size} ranks on "
              f"{group.device.type}, transport {group.transport}",
              flush=True)
    t0 = time.time()
    state, history = trainer.run(data, verbose=lead)
    if not lead:
        return None
    history["wall_s"] = time.time() - t0
    history["config"] = {"population": args.population,
                         "cohort": args.cohort,
                         "devices": group.world_size,
                         "aggregator": fed.aggregator,
                         "attack": fed.attack,
                         "malicious": fed.num_malicious,
                         "attack_scale": fed.attack_scale,
                         "participation": fed.participation,
                         "coalition": fed.coalition,
                         "coalition_size": fed.coalition_size,
                         "compressor": fed.compressor,
                         "scenario": args.scenario,
                         "transport": group.transport}
    _write(args, f"{args.dataset}__population.json", history)
    return history


def kernel_launches():
    """The aggregation kernels' launches in this process so far (none on
    the CPU, where the ops run their plain versions)."""
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate
    from repro_torch.kernels.robust_combine import robust_combine
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate
    return {"weighted_aggregate": weighted_aggregate.launches,
            "robust_combine": robust_combine.launches,
            "dequant_aggregate": dequant_aggregate.launches}


def _write(args, name: str, history) -> None:
    """Rank 0's end of a run: its kernel launches, the JSON history, and
    the ``--assert-malicious-below`` gate."""
    print("rank 0 kernel launches: " + json.dumps(kernel_launches()),
          flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(history, f, indent=1)
    if args.assert_malicious_below is not None:
        final = history["malicious_weight"][-1]
        if not final < args.assert_malicious_below:
            raise SystemExit(
                f"malicious_weight={final:.4f} did not drop below "
                f"{args.assert_malicious_below} after "
                f"{len(history['malicious_weight'])} rounds")
        print(f"assert ok: malicious_weight={final:.4f} < "
              f"{args.assert_malicious_below}")


def rank_main(group, args):
    """What each rank runs: the population tier or the pod round."""
    if args.population is not None:
        return run_population(group, args)
    return run_pod(group, args)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda":
        from repro_torch.core.engine import resolve_device
        resolve_device("cuda")      # raises without a card
    backend = resolve_dist_backend(args.device, args.dist_backend,
                                   args.clients)
    if args.population is not None:
        if args.cohort is None:
            raise SystemExit("--population requires --cohort")
        if args.cohort % args.clients != 0:
            raise SystemExit(
                f"--cohort {args.cohort} must divide evenly across "
                f"--clients {args.clients} ranks for the cohort-axis "
                "sharding")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != args.clients:
            raise SystemExit(f"WORLD_SIZE={world} but --clients "
                             f"{args.clients}: the pod runs one client a "
                             "rank")
        import torch.distributed as dist
        group = init_rank(int(os.environ["RANK"]), world, args.device,
                          backend)
        try:
            rank_main(group, args)
        finally:
            dist.destroy_process_group()
        return
    try:
        # ranks on the CPU share its cores rather than each taking all
        threads = (max(1, (os.cpu_count() or 1) // args.clients)
                   if args.device == "cpu" else 0)
        run_ranks(rank_main, args.clients, args, device_type=args.device,
                  backend=backend, threads=threads)
    except RuntimeError as err:
        raise SystemExit(f"pod run failed: {err}") from None


if __name__ == "__main__":
    main()
