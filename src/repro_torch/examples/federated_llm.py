"""Federated fine-tuning of an LM backbone with FedTest, the twin of the
reference's ``examples/federated_llm.py`` at its sizes (the reduced
config in f32, a vocabulary of 97, 4 users, ``random_weights``).

Each client holds a topic-skewed shard of a synthetic bigram language;
clients cross-test each other's models on their own held-out text (token
accuracy as the FedTest score; the kernel ops under vmap), the server
aggregates with the moving-average accuracy^4 weights, and at the end
the global model serves a greedy continuation (prefill and decode on the
kernel ops).

  PYTHONPATH=src python -m repro_torch.examples.federated_llm
  PYTHONPATH=src python -m repro_torch.examples.federated_llm \\
      --arch mamba2-2.7b --malicious 1 --device cpu
  PYTHONPATH=src python -m repro_torch.examples.federated_llm \\
      --arch granite-moe-1b-a400m --malicious 1 --device cpu

``--arch`` takes any LM of the port's registry (dense, moe, ssm,
hybrid); a MoE model trains and cross-tests on the capacity route and
serves its continuation dropless.

It runs on the card unless given ``--device cpu``, and raises without one.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.config import FedConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.core import FederatedTrainer
from repro_torch.core.engine import resolve_device
from repro_torch.launch.train import make_lm_federated_dataset
from repro_torch.models import build_model


def main(argv=None):
    """Runs the example; returns (trainer, final state, history, data)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--users", type=int, default=4)
    ap.add_argument("--malicious", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--vocab", type=int, default=97)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduce_for_smoke(get_config(args.arch)).replace(
        dtype="float32", vocab_size=args.vocab)
    model = build_model(cfg)
    print(f"federated fine-tune: {cfg.name} "
          f"({model.param_count():,} params), "
          f"{args.users} clients, {args.malicious} malicious, on {device}")

    data = make_lm_federated_dataset(args.vocab, args.users, seq_len=32,
                                     seqs_per_user=48, device=device)
    fed = FedConfig(num_users=args.users, num_testers=2,
                    num_malicious=args.malicious, local_steps=8,
                    attack="random_weights")
    tc = TrainConfig(optimizer="adamw", lr=2e-3, schedule="constant",
                     batch_size=16, grad_clip=1.0)
    trainer = FederatedTrainer(model, fed, tc, eval_batch=32, device=device)

    state, hist = trainer.run(data, rounds=args.rounds, verbose=True)

    # serve the federated model: greedy continuation of a held-out prefix
    # (the reference's loop: the prefix's last token is fed again first)
    prefix = data.global_x[:1, :12]
    with torch.no_grad():
        _, cache = model.prefill(state.global_params, {"tokens": prefix},
                                 cache_len=32)
        toks = prefix[:, -1:]
        generated = []
        for _ in range(12):
            logits, cache = model.decode_step(state.global_params, cache,
                                              toks)
            toks = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            generated.append(int(toks[0, 0]))
    truth = data.global_x[0, 12:24].tolist()
    hits = sum(g == t for g, t in zip(generated, truth))
    print(f"\nprefix    : {prefix[0].tolist()}")
    print(f"generated : {generated}")
    print(f"truth     : {truth}")
    print(f"greedy continuation matches {hits}/12 ground-truth tokens")
    return trainer, state, hist, data


if __name__ == "__main__":
    main()
