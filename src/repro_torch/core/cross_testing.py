"""Cross-testing (the heart of FedTest, Fig. 3b), counterpart of
``repro/core/cross_testing.py`` for the cnn/mlp families.

Each selected tester evaluates every client's model on its own held-out
data: the ``[K, N]`` accuracy matrix.

* :func:`cross_test_batched` — what the round runs: ``torch.func.vmap``
  over the stacked client params (through ``functional_call`` in the
  model facade), nested in a vmap over the testers, one batched forward
  for the whole matrix;
* :func:`cross_test_reference` — one eval per (tester, client) pair, the
  oracle the tests hold the batched form against.

``torch.argmax`` and ``jnp.argmax`` both return the first maximal index,
so equal logits give equal predictions in both packages.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from repro_torch.utils import tree_leaves, tree_map


def make_eval_fn(model) -> Callable:
    """Returns eval_fn(params, bx, by) -> accuracy in [0, 1] (fp32)."""
    def eval_fn(params, bx, by):
        logits = model.forward_train(params, {"images": bx})
        return (torch.argmax(logits, dim=-1) == by).float().mean()
    return eval_fn


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
