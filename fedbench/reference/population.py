"""The population tier's FedTest round in plain PyTorch, float32: N
clients, of whom a round samples a cohort of at most C, the K testers
recruited from the cohort, every client's shard drawn on demand from a
keyed counter stream.

The draws follow, as frozen copies, the order in which the measured
round takes them from its generator: the testers' ``[N]`` uniforms (the
K largest), the participation's ``[N]`` uniforms (a client is sampled
below C / N; nobody sampled means everybody), then ``[N, steps, batch]``
batch uniforms, of which the cohort's rows are used. The cohort is the
sampled clients in ascending order, its first C kept; tester k is the
cohort member at slot ``id_k mod (cohort size)``.

The shards and the attack's noise are keyed Philox streams
(``philox.py``): a shard row of client i in stream s is the label word
of counter ``(0, 2s, i, row)``, ``(word * classes) >> 32``, and the
image of its class prototype plus ``noise`` times the normals of
counters ``(q, 2s + 1, i, row)``; a malicious client's noise for leaf l
in round r is the normals of counters ``(q, l, i, r)`` under the run's
noise key. Step 4 reports, for a client outside the cohort, the
tester's accuracy of the global model; scores move only for the
sampled clients, and the weights are renormalised over them.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from fedbench.reference import fedtest, philox
from fedbench.weights import leaves

# the shards' streams, and the stream constant of the attack's noise key
TRAIN, TEST, GLOBAL = 0, 1, 2
NOISE_STREAM = 12


def shards(key, protos: torch.Tensor, noise: float, stream: int,
           clients: torch.Tensor, rows: int):
    """Rows ``0..rows`` of each of ``clients`` in ``stream``: images
    ``[K, rows, H, W, C]`` and int32 labels ``[K, rows]``."""
    dev = protos.device
    shape = tuple(protos.shape[1:])
    d = protos[0].numel()
    k = clients.shape[0]
    who = clients.long()[:, None].expand(k, rows).reshape(-1, 1)
    row = torch.arange(rows, device=dev)[None].expand(k, rows).reshape(-1, 1)
    word = philox.philox((0, 2 * stream, who, row), key)[0][:, 0]
    labels = (word * protos.shape[0]) >> 32
    z = philox.stream_normals(key, (2 * stream + 1, who, row), d, dev)
    images = protos[labels] + noise * z.reshape((-1,) + shape)
    return (images.reshape((k, rows) + shape),
            labels.to(torch.int32).reshape(k, rows))


def keyed_noise(key, client: int, round_idx: int, like: Dict[str, Any]):
    """The attack's standard normals of ``client`` in ``round_idx``, one
    tensor a leaf of ``like`` (sorted-name order)."""
    out = []
    for i, (_, t) in enumerate(leaves(like)):
        z = philox.stream_normals(key, (i, client, round_idx), t.numel(),
                                  t.device)
        out.append(z.reshape(t.shape))
    return out


def draw_round(gen: torch.Generator, traffic: dict):
    """``(testers [K], eff [N] f32, idx [C] int64 (N: unfilled),
    valid [C] bool, rows [C, steps, batch])``."""
    fed, pop = traffic["fed"], traffic["data"]
    n, dev, cap = fed["num_users"], gen.device, fed["cohort"]
    u = torch.rand((n,), generator=gen, device=dev)
    picked = torch.topk(u, fed["num_testers"]).indices
    u = torch.rand((n,), generator=gen, device=dev)
    part = (u < fed["participation"]).float()
    if not bool(part.any()):
        part = torch.ones_like(part)
    ids = torch.where(part > 0, torch.arange(n, device=dev),
                      torch.full((), n, device=dev))
    idx = torch.sort(ids).values[:cap]
    valid = idx < n
    eff = part * (torch.cumsum(part, 0) <= cap).float()
    count = max(int(valid.sum()), 1)
    testers = idx[picked.long() % count].clamp(max=n - 1)
    u = torch.rand((n, fed["local_steps"], traffic["train"]["batch_size"]),
                   generator=gen, device=dev)
    per = pop["per_client"]
    rows = torch.clamp((u[idx.clamp(max=n - 1)] * per).to(torch.int64),
                       max=per - 1)
    return testers, eff, idx, valid, rows


def run_rounds(model, params, data: dict, traffic: dict, gen, rounds: int,
               first_round: int = 0) -> List[dict]:
    """``rounds`` population rounds from ``params``; records as
    ``fedtest.run_rounds``'s, the cohort's slots in ``idx``."""
    fed, pop = traffic["fed"], traffic["data"]
    n = fed["num_users"]
    bad = set(fedtest.malicious_clients(n, fed["num_malicious"]))
    opt = fedtest.OPTIMIZERS[traffic["train"]["optimizer"]](traffic["train"])
    key, protos = data["shard_key"], data["protos"]
    scores = torch.zeros((n,), device=gen.device)
    out = []
    for r in range(first_round, first_round + rounds):
        testers, eff, idx, valid, rows = draw_round(gen, traffic)
        members = idx[valid].tolist()
        cx, cy = shards(key, protos, pop["noise"], TRAIN,
                        idx[valid], pop["per_client"])
        tx, ty = shards(key, protos, pop["noise"], TEST, testers,
                        traffic["eval_rows"])
        trained, losses = [], []
        for s in range(len(members)):
            m, loss = fedtest.local_train(model, opt, params, cx[s][rows[s]],
                                          cy[s][rows[s]])
            trained.append(m)
            losses.append(loss)
        models = attack(trained, members, bad, data["noise_key"], r, fed,
                        model.store)
        with torch.no_grad():
            acc_c = fedtest.cross_test(model, models, tx, ty,
                                       torch.arange(len(testers)))
            base = fedtest.cross_test(model, [params], tx, ty,
                                      torch.arange(len(testers)))
            acc = base.expand(-1, n).clone()
            acc[:, idx[valid]] = acc_c
            scores, w = population_scores(acc, scores, eff, r, fed)
            params = fedtest.aggregate(models, w[idx[valid]], model.store)
        out.append({"testers": testers, "idx": idx, "valid": valid,
                    "eff": eff, "losses": torch.stack(losses), "acc": acc,
                    "scores": scores, "weights": w, "params": params,
                    **({"trained": trained, "models": models}
                       if r == first_round else {})})
    return out


def attack(trained: List[dict], members, bad, key, round_idx: int,
           fed: dict, store=lambda t: t) -> List[dict]:
    """Step 3 on the cohort: a malicious member's model replaced by its
    keyed noise times each leaf's spread."""
    return [fedtest.random_weights(m, keyed_noise(key, c, round_idx, m),
                                   fed.get("attack_scale", 1.0), store)
            if c in bad else m for m, c in zip(trained, members)]


def population_scores(acc, scores, eff, rounds_seen: int, fed: dict):
    """``fedtest_scores`` over the reporting testers and the sampled
    clients: the testers' mean accuracy (every recruited tester is
    sampled), scores moved only where ``eff``, weights renormalised over
    the sampled clients."""
    power = (1.0 if rounds_seen < fed.get("power_warmup_rounds", 2)
             else fed["score_power"])
    powered = acc.mean(0).clamp(0.0, 1.0) ** power
    decay = fed["score_decay"]
    new = powered if rounds_seen == 0 else decay * scores + (
        1 - decay) * powered
    new = torch.where(eff > 0, new, scores)
    s = new.clamp(min=0.0)
    total = s.sum()
    w = s / total if total > 1e-12 else torch.full_like(s, 1 / s.numel())
    w = w * eff
    total = w.sum()
    w = w / total if total > 1e-12 else eff / eff.sum()
    return new, w


@torch.no_grad()
def numbers(prog: dict, ref: List[dict], model, data: dict,
            traffic: dict) -> dict:
    """``compare.numbers`` for a cohort round: the program's ``[C]``
    stacks are read at the reference cohort's filled slots, its ``[N]``
    losses at their clients."""
    from fedbench.reference import compare
    fed, r1 = traffic["fed"], ref[0]
    slots = int(r1["valid"].sum())
    members = r1["idx"][r1["valid"]]
    lp = prog["losses"].float()[members]
    lr = r1["losses"].float()
    rel = (lp - lr).abs() / lr.abs().clamp(min=1e-12)

    trained, models = prog["trained"][:slots], prog["models"][:slots]
    bad = set(fedtest.malicious_clients(fed["num_users"],
                                        fed["num_malicious"]))
    attacked = attack(trained, members.tolist(), bad, data["noise_key"], 0,
                      fed)
    worst = max(compare._norm(a.float() - b.float())
                / max(compare._norm(b), 1e-30)
                for got, want in zip(models, attacked)
                for (_, a), (_, b) in zip(leaves(got), leaves(want)))

    pop = traffic["data"]
    tx, ty = shards(data["shard_key"], data["protos"], pop["noise"], TEST,
                    r1["testers"], traffic["eval_rows"])
    every = torch.arange(len(r1["testers"]))
    base = fedtest.cross_test(model, [data["params0"]], tx, ty, every)
    acc = base.expand(-1, fed["num_users"]).clone()
    acc[:, members] = fedtest.cross_test(model, models, tx, ty, every)
    accuracy = float((prog["acc"].float() - acc).abs().max())

    _, w = population_scores(prog["acc"].float(),
                             torch.zeros_like(r1["scores"]), r1["eff"], 0,
                             fed)
    weights = float((prog["weights"].float() - w).abs().max() / w.max())

    summed = fedtest.aggregate(models, prog["weights"].float()[members])
    got = dict(leaves(prog["params"]))
    gaps = {k: compare._norm(got[k].float() - t) for k, t in leaves(summed)}
    norms = {k: compare._norm(t) for k, t in leaves(summed)}
    med = sorted(norms.values())[len(norms) // 2]
    first = r1["norms"]
    return {"train_loss": float(rel.median()),
            "train_loss_max": float(rel.max()), "attack": worst,
            "accuracy": accuracy, "weights": weights,
            "aggregate": max(gaps[k] / max(norms[k], med) for k in gaps),
            "update": compare.leaf_gap(prog["norms"][0], first, first),
            "change": compare.leaf_gap(prog["norms"][-1], ref[-1]["norms"],
                                       first),
            **compare.eval_numbers(model, prog["eval"], data["global_x"],
                                   data["global_y"])}
