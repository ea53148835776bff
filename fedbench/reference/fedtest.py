"""The FedTest round (the paper's Algorithm 1) in plain PyTorch, client
by client, in float32: the round's draws, local training, the
``random_weights`` attack, cross-testing, the ``fedtest`` scores and the
score-weighted sum.

The draws are a frozen copy of the order in which the measured round
takes them from its ``torch.Generator``: the testers (``[N]`` uniforms,
the K largest), then the batch rows (``[N, steps, batch]`` uniforms times
each client's row count, clamped into it), then each malicious client's
standard normals, one tensor a parameter leaf in sorted-name order. The
reference seeds its own generator as the benchmark seeds the program's,
so both read the same numbers and nothing is taken from the program.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch

from fedbench.weights import leaves, tree_from


def malicious_clients(users: int, count: int) -> List[int]:
    """The attackers: the last ``count`` clients."""
    return list(range(users - count, users))


def draw_round(gen: torch.Generator, traffic: dict, counts: torch.Tensor,
               shapes: List[torch.Size]):
    fed = traffic["fed"]
    n, dev = fed["num_users"], gen.device
    u = torch.rand((n,), generator=gen, device=dev)
    testers = torch.topk(u, fed["num_testers"]).indices
    u = torch.rand((n, fed["local_steps"], traffic["train"]["batch_size"]),
                   generator=gen, device=dev)
    rows = torch.minimum((u * counts[:, None, None]).to(torch.int64),
                         (counts.to(torch.int64) - 1)[:, None, None])
    noise = {}
    if fed["attack"] == "random_weights":
        for c in malicious_clients(n, fed["num_malicious"]):
            noise[c] = [torch.randn(s, generator=gen, device=dev)
                        for s in shapes]
    return testers, rows, noise


class SGD:
    def __init__(self, train: dict):
        self.lr = train["lr"]

    def init(self, params):
        return None

    def step(self, params, grads, state):
        return [p - self.lr * g for p, g in zip(params, grads)], state


class AdamW:
    """Adam with decoupled weight decay on every leaf, bias-corrected
    moments, ``eps`` outside the square root."""

    def __init__(self, train: dict):
        self.lr = train["lr"]
        self.b1, self.b2 = train.get("beta1", 0.9), train.get("beta2", 0.95)
        self.eps = train.get("eps", 1e-8)
        self.wd = train.get("weight_decay", 0.1)

    def init(self, params):
        return (0, [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def step(self, params, grads, state):
        t, ms, vs = state
        t += 1
        out, new_m, new_v = [], [], []
        for p, g, m, v in zip(params, grads, ms, vs):
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            u = (m / (1 - self.b1 ** t)) / (
                torch.sqrt(v / (1 - self.b2 ** t)) + self.eps)
            out.append(p - self.lr * (u + self.wd * p))
            new_m.append(m)
            new_v.append(v)
        return out, (t, new_m, new_v)


OPTIMIZERS = {"sgd": SGD, "adamw": AdamW}


def local_train(model, opt, params: Dict[str, Any], xs, ys):
    """One client's local steps on ``xs [steps, batch, ...]``; returns the
    trained tree and the mean of its steps' losses."""
    names = [k for k, _ in leaves(params)]
    ps = [t.detach().float() for _, t in leaves(params)]
    state = opt.init(ps)
    losses = []
    for s in range(xs.shape[0]):
        ps = [p.requires_grad_() for p in ps]
        loss = model.loss(tree_from(dict(zip(names, ps))), xs[s], ys[s])
        grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            ps, state = opt.step([p.detach() for p in ps], grads, state)
            ps = [model.store(p) for p in ps]
        losses.append(loss.detach())
    return tree_from(dict(zip(names, ps))), torch.stack(losses).mean()


def random_weights(trained: Dict[str, Any], noise, scale: float,
                   store=lambda t: t):
    """Random weights with the trained model's per-leaf spread (the
    population standard deviation, plus 1e-6), kept by ``store``."""
    out = {k: store(z * (t.float().std(correction=0) + 1e-6) * scale)
           for (k, t), z in zip(leaves(trained), noise)}
    return tree_from(out)


def fedtest_scores(acc, scores, rounds_seen: int, fed: dict):
    """Algorithm 1's moving average of the testers' mean accuracy to the
    power ``score_power`` (1 for the first ``power_warmup_rounds``), and
    the weights, the scores over their sum."""
    power = (1.0 if rounds_seen < fed.get("power_warmup_rounds", 2)
             else fed["score_power"])
    powered = acc.mean(0).clamp(0.0, 1.0) ** power
    decay = fed["score_decay"]
    new = powered if rounds_seen == 0 else decay * scores + (
        1 - decay) * powered
    s = new.clamp(min=0.0)
    total = s.sum()
    w = s / total if total > 1e-12 else torch.full_like(s, 1 / s.numel())
    return new, w


@contextlib.contextmanager
def precision(name: str):
    """``float32`` runs float32 products in full float32; ``tf32`` lets
    cuBLAS and cuDNN round their inputs to TF32 (the control)."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def unstack(stacked: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """A ``[N, ...]``-stacked tree -> N trees."""
    flat = list(leaves(stacked))
    return [tree_from({k: t[c] for k, t in flat}) for c in range(n)]


def attack(trained: List[dict], noise, fed: dict,
           store=lambda t: t) -> List[dict]:
    """Step 3: the malicious clients' models replaced."""
    out = list(trained)
    for c, z in noise.items():
        out[c] = random_weights(trained[c], z, fed.get("attack_scale", 1.0),
                                store)
    return out


@torch.no_grad()
def cross_test(model, models: List[dict], tx, ty, testers) -> torch.Tensor:
    """Step 4: ``[K, N]``, tester k's accuracy of client c's model on the
    tester's own rows."""
    models = [tree_from({k: t.float() for k, t in leaves(m)})
              for m in models]
    return torch.stack([
        torch.stack([model.accuracy(m, tx[k], ty[k]) for m in models])
        for k in testers.tolist()])


@torch.no_grad()
def aggregate(models: List[dict], w, store=lambda t: t) -> Dict[str, Any]:
    """Step 7: the weighted sum of the models, leaf by leaf, in float32,
    kept by ``store``."""
    flat = [dict(leaves(m)) for m in models]
    return tree_from({k: store(sum(w[c] * flat[c][k].float()
                                   for c in range(len(models))))
                      for k in flat[0]})


def run_rounds(model, params, data: dict, traffic: dict, gen, rounds: int
               ) -> List[dict]:
    """``rounds`` rounds from ``params``: a record a round with the
    draws (``testers``, ``noise``), the clients' losses ``[N]``, the
    trained and the attacked models (first round only), the ``[K, N]``
    accuracies, the scores, the weights and the new global tree."""
    fed = traffic["fed"]
    n = fed["num_users"]
    opt = OPTIMIZERS[traffic["train"]["optimizer"]](traffic["train"])
    tx = data["test_x"][:, :traffic["eval_rows"]]
    ty = data["test_y"][:, :traffic["eval_rows"]]
    scores = torch.zeros((n,), device=gen.device)
    out = []
    for r in range(rounds):
        shapes = [t.shape for _, t in leaves(params)]
        testers, rows, noise = draw_round(gen, traffic, data["counts"],
                                          shapes)
        trained, losses = [], []
        for c in range(n):
            xs, ys = data["train_x"][c][rows[c]], data["train_y"][c][rows[c]]
            m, loss = local_train(model, opt, params, xs, ys)
            trained.append(m)
            losses.append(loss)
        models = attack(trained, noise, fed, model.store)
        acc = cross_test(model, models, tx, ty, testers)
        scores, w = fedtest_scores(acc, scores, r, fed)
        params = aggregate(models, w, model.store)
        rec = {"testers": testers, "noise": noise,
               "losses": torch.stack(losses), "acc": acc, "scores": scores,
               "weights": w, "params": params}
        if r == 0:
            rec.update(trained=trained, models=models)
        out.append(rec)
    return out
