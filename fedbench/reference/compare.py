"""The numbers that decide ``correct``: what the program's first rounds
produced, through the window's own call, against the reference.

Ten local SGD steps at the paper's rate amplify a rounding difference
some ten-thousandfold (the first steps overshoot), and later rounds add
the cross-test's argmax flips on top: two float32 runs of a round part
there as far as a TF32 one does (PERF.md). So the reference checks the
first round stage by stage, each stage from the state the program
handed it, and the rounds end to end only where their readings
separate:

* ``train_loss``: local training from the same global model and batch
  rows: the median client's gap of its mean local loss, over the
  reference's (steady where the widest client's is not);
  ``train_loss_max``: the widest client's;
* ``attack``: the ``random_weights`` attack, applied by the reference to
  the program's trained models with its own draws of the noise: the
  widest gap of a client's leaf, over the norm of the leaf;
* ``accuracy``: cross-testing of the program's attacked models by the
  testers the reference draws, on their own rows: the widest gap of an
  accuracy ``[K, N]``;
* ``weights``: the ``fedtest`` weights of the program's accuracies: the
  widest gap over the largest weight;
* ``aggregate``: the weighted sum of the program's models by the
  program's weights: the worst leaf's gap over the larger of its norm and
  the median leaf's;
* ``update``: the first round's change of the global model end to end,
  against the reference's own round, by its worst leaf: the gap between
  the two norms over the larger of the reference's norm of that leaf and
  of the median leaf's;
* ``change``: the same after all checked rounds; ``change_median``:
  the median leaf's gap there (steady where the worst leaf's is not:
  AdamW on bfloat16 parts a few leaves' changes by rounding alone,
  PERF.md);
* ``eval_logprob``: the program's first global eval, its own forward at
  the window's rows, against the reference's forward of the parameters
  it evaluated: the mean gap of a position's label log-probability over
  the reference's mean magnitude (a forward's rounding, which training
  does not amplify; the widest gap of the top token's logit and the gap
  of the mean swing or cancel, PERF.md).

Leaves whose first update in the reference is under a thousandth of the
median leaf's (nought to rounding) are left out of ``update`` and
``change``.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from fedbench.reference import fedtest
from fedbench.weights import leaves, tree_from


# rows of a forward at a time, so that a block's float32 logits fit
EVAL_BLOCK = 64


def eval_stats(logits, labels) -> Dict[str, torch.Tensor]:
    """Each position's label log-probability, on the host."""
    lp = []
    for lo in range(0, logits.shape[0], EVAL_BLOCK):
        z = logits[lo:lo + EVAL_BLOCK].float()
        y = labels[lo:lo + EVAL_BLOCK].long().clamp(min=0)
        lp.append(torch.log_softmax(z, -1).gather(-1, y[..., None])[..., 0]
                  .cpu())
    return {"label_logprob": torch.cat(lp)}


def _logit_blocks(model, params, x):
    p = tree_from({k: t.float() for k, t in leaves(params)})
    for lo in range(0, x.shape[0], EVAL_BLOCK):
        yield lo, model.eval_logits(p, x[lo:lo + EVAL_BLOCK])


@torch.no_grad()
def reference_eval_stats(model, params, x, y) -> Dict[str, torch.Tensor]:
    """``eval_stats`` of the reference's own forward, block by block."""
    parts = [eval_stats(z, y[lo:lo + z.shape[0]])
             for lo, z in _logit_blocks(model, params, x)]
    return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}


@torch.no_grad()
def eval_numbers(model, rec: dict, x, y) -> Dict[str, float]:
    """``eval_logprob`` of a global eval's record (``label_logprob``, the
    ``params`` it evaluated) on rows ``x, y``."""
    got = rec["label_logprob"]
    n = got.shape[0]
    want = reference_eval_stats(model, rec["params"], x[:n],
                                y[:n])["label_logprob"]
    valid = (y[:n] != -1).cpu()
    gap = (got - want)[valid].abs().mean()
    return {"eval_logprob": float(gap / want[valid].abs().mean().clamp(
        min=1e-12))}


def change_norms(after, before) -> Dict[str, float]:
    """Each leaf's norm of ``after - before``, in float32."""
    b = dict(leaves(before))
    return {k: float(torch.linalg.vector_norm(t.float() - b[k].float()))
            for k, t in leaves(after)}


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              first: Dict[str, float]) -> Dict[str, float]:
    """Each kept leaf's gap between the two norms of change, over the
    larger of the reference's norm and the median leaf's."""
    med_first = statistics.median(first.values())
    keep = [k for k in ref if first[k] >= 1e-3 * med_first]
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             first: Dict[str, float]) -> float:
    return max(leaf_gaps(prog, ref, first).values())


@torch.no_grad()
def numbers(prog: dict, ref: List[dict], model, data: dict,
            traffic: dict) -> Dict[str, float]:
    """``prog``: the program's first round (``losses``, ``trained`` and
    ``models`` as lists of trees, ``acc``, ``weights``, ``params``) and
    each checked round's leaf ``norms`` of change (``norms``); ``ref``:
    the reference's own rounds (``fedtest.run_rounds``) with their
    ``norms``."""
    fed, r1 = traffic["fed"], ref[0]
    lp, lr = prog["losses"].float(), r1["losses"].float()
    rel = (lp - lr).abs() / lr.abs().clamp(min=1e-12)

    attacked = fedtest.attack(prog["trained"], r1["noise"], fed)
    attack = max(_norm(a.float() - b.float()) / max(_norm(b), 1e-30)
                 for got, want in zip(prog["models"], attacked)
                 for (_, a), (_, b) in zip(leaves(got), leaves(want)))

    n = traffic["eval_rows"]
    acc = fedtest.cross_test(model, prog["models"], data["test_x"][:, :n],
                             data["test_y"][:, :n], r1["testers"])
    accuracy = float((prog["acc"].float() - acc).abs().max())

    _, w = fedtest.fedtest_scores(prog["acc"].float(),
                                  torch.zeros_like(lr), 0, fed)
    weights = float((prog["weights"].float() - w).abs().max() / w.max())

    summed = fedtest.aggregate(prog["models"], prog["weights"].float())
    got = dict(leaves(prog["params"]))
    gaps = {k: _norm(got[k].float() - t) for k, t in leaves(summed)}
    norms = {k: _norm(t) for k, t in leaves(summed)}
    med = statistics.median(norms.values())
    aggregate = max(gaps[k] / max(norms[k], med) for k in gaps)

    first = r1["norms"]
    last = leaf_gaps(prog["norms"][-1], ref[-1]["norms"], first)
    return {"train_loss": float(rel.median()),
            "train_loss_max": float(rel.max()), "attack": attack,
            "accuracy": accuracy, "weights": weights,
            "aggregate": aggregate,
            "update": leaf_gap(prog["norms"][0], first, first),
            "change": max(last.values()),
            "change_median": statistics.median(last.values()),
            **eval_numbers(model, prog["eval"], data["global_x"],
                           data["global_y"])}


def check(nums: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every limited number at or under its limit;
    a number that is not finite fails."""
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
