"""Cross-testing (the heart of FedTest, Fig. 3b), counterpart of
``repro/core/cross_testing.py``.

Each selected tester evaluates every client's model on its own held-out
data: the ``[K, N]`` accuracy matrix, a classifier's accuracy or an LM's
token accuracy over the labels that are not -1 (:func:`make_eval_fn`).
An LM's eval goes through the kernel ops (a model built without
``differentiable``, as the round keeps it): under the batched
cross-test's nested vmap their fold rules launch ``flash_attention`` /
``ssd_scan`` once a layer for all K x N models.

* :func:`cross_test_batched` — what the round runs: ``torch.func.vmap``
  over the stacked client params (through ``functional_call`` in the
  model facade), nested in a vmap over the testers, one batched forward
  for the whole matrix;
* :func:`cross_test_reference` — one eval per (tester, client) pair, the
  oracle the batched form is held against, bitwise;
* :func:`cross_test_accuracies` — dispatch by name between the two
  (``FedConfig.crosstest_impl``);
* :func:`cross_test_tiled` — the population tier's: the matrix in
  ``[K, block]`` tiles over the model axis, so the live eval
  activations scale with ``block``, not with the cohort.

``torch.argmax`` and ``jnp.argmax`` both return the first maximal index,
so equal logits give equal predictions in both packages.

Eval-batch resampling (``FederatedTrainer.eval_resample_every``): each
tester's eval rows are redrawn once a schedule bucket
(``round_idx // resample_every``), from a generator seeded from the run's
seed, :data:`EVAL_BATCH_STREAM` and the bucket alone
(:func:`eval_batch_indices`), never from the round's carried generator:
the indices are a pure function of (run seed, bucket), so a resumed run
draws what an unbroken one draws (DESIGN.md §10).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import vmap

from repro_torch.utils import derived_seed, tree_leaves, tree_map

# the eval-batch stream's constant, the reference's fold_in constant
EVAL_BATCH_STREAM = 11

CROSSTEST_IMPLS = ("batched", "reference")


def make_eval_fn(model) -> Callable:
    """Returns eval_fn(params, bx, by) -> accuracy in [0, 1] (fp32): a
    classifier's over its images, an LM's over the tokens whose label is
    not -1 (``correct / max(valid, 1)``)."""
    if model.cfg.family in ("cnn", "mlp"):
        def eval_fn(params, bx, by):
            logits = model.forward_train(params, {"images": bx})
            return (torch.argmax(logits, dim=-1) == by).float().mean()
        return eval_fn

    def lm_eval_fn(params, bx, by):
        logits = model.forward_train(params, {"tokens": bx})
        valid = by != -1
        correct = (torch.argmax(logits, dim=-1) == by) & valid
        return correct.sum().float() / valid.sum().clamp(min=1)
    return lm_eval_fn


def cross_test_batched(eval_fn, stacked_params, tester_x, tester_y
                       ) -> torch.Tensor:
    """Accuracy matrix A[k, c] = acc of client c's model on tester k's
    data, in one batched eval. stacked_params: leaves [N, ...];
    tester_x/y: [K, batch, ...]."""
    def one_tester(bx, by):
        return vmap(lambda p: eval_fn(p, bx, by))(stacked_params)

    return vmap(one_tester)(tester_x, tester_y)


def cross_test_reference(eval_fn, stacked_params, tester_x, tester_y
                         ) -> torch.Tensor:
    """One eval per (tester, client) pair — the parity oracle."""
    num = tree_leaves(stacked_params)[0].shape[0]
    rows = []
    for bx, by in zip(tester_x, tester_y):
        rows.append(torch.stack([
            eval_fn(tree_map(lambda leaf, c=c: leaf[c], stacked_params),
                    bx, by)
            for c in range(num)]))
    return torch.stack(rows)


def cross_test_accuracies(eval_fn, stacked_params, tester_x, tester_y,
                          impl: str = "batched") -> torch.Tensor:
    """The [K, N] accuracy matrix by ``impl`` (:data:`CROSSTEST_IMPLS`);
    the two are bitwise equal."""
    if impl == "batched":
        return cross_test_batched(eval_fn, stacked_params, tester_x,
                                  tester_y)
    if impl == "reference":
        return cross_test_reference(eval_fn, stacked_params, tester_x,
                                    tester_y)
    raise ValueError(f"crosstest_impl must be one of {CROSSTEST_IMPLS}, "
                     f"got {impl!r}")


def cross_test_tiled(eval_fn, stacked_params, tester_x, tester_y, *,
                     block: int = 0, impl: str = "batched") -> torch.Tensor:
    """The accuracy matrix in ``[K, block]`` tiles over the model axis
    (DESIGN.md §11): a Python loop over the blocks, the twin of the
    reference's ``lax.map``. ``block <= 0`` or ``block >= C`` is the
    untiled call. A ragged tail is wrap-padded with the leading rows and
    sliced off, so padding is recomputed work that never reaches the
    caller."""
    c = tree_leaves(stacked_params)[0].shape[0]
    if block <= 0 or block >= c:
        return cross_test_accuracies(eval_fn, stacked_params, tester_x,
                                     tester_y, impl=impl)
    num_blocks = -(-c // block)
    pad = num_blocks * block - c
    padded = (tree_map(lambda t: torch.cat([t, t[:pad]]), stacked_params)
              if pad else stacked_params)
    tiles = [cross_test_accuracies(
        eval_fn, tree_map(lambda t, lo=b * block: t[lo:lo + block], padded),
        tester_x, tester_y, impl=impl) for b in range(num_blocks)]
    return torch.cat(tiles, dim=1)[:, :c]


# ------------------------------------------------------- eval-batch sampling
def eval_indices_from_uniforms(u: torch.Tensor, counts: torch.Tensor
                               ) -> torch.Tensor:
    """``u [N, eval_batch]`` uniforms -> int64 row indices, the reference's
    ``int(u * count)`` with the product in f32."""
    return (u * counts[:, None]).to(torch.int64)


def eval_batch_indices(seed: int, counts: torch.Tensor, eval_batch: int,
                       bucket: int) -> torch.Tensor:
    """[N, eval_batch] per-tester gather indices for one schedule bucket,
    drawn on ``counts``' device from a fresh generator seeded from
    ``(seed, EVAL_BATCH_STREAM, bucket)``: rounds of one bucket share a
    batch, a new bucket resamples."""
    gen = torch.Generator(device=counts.device)
    gen.manual_seed(derived_seed(seed, EVAL_BATCH_STREAM, bucket))
    u = torch.rand((counts.shape[0], eval_batch), generator=gen,
                   device=counts.device)
    return eval_indices_from_uniforms(u, counts)


def gather_eval_batches(xs: torch.Tensor, ys: torch.Tensor,
                        idx: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, eval_batch, ...] tester batches from stacked client data."""
    rows = torch.arange(xs.shape[0], device=idx.device)[:, None]
    return xs[rows, idx], ys[rows, idx]


def sampled_eval_batches(seed: int, test_data, eval_batch: int,
                         round_idx: int, resample_every: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The round's tester eval batches under the resampling schedule."""
    idx = eval_batch_indices(seed, test_data.counts, eval_batch,
                             round_idx // resample_every)
    return gather_eval_batches(test_data.xs, test_data.ys, idx)
