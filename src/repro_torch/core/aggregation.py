"""Model aggregation primitives (counterpart of
``repro/core/aggregation.py``).

Every aggregation scheme reduces a client-stacked param tree with a
``[N]`` weight simplex; how the weights are produced is a registered
strategy (``repro_torch.strategies.AGGREGATORS``). The paper's three
schemes: FedTest (``repro_torch.core.scoring``), FedAvg (weights by
sample count) and the accuracy-based baseline (weights by each model's
accuracy on the server's held-out set).

The weighted sum runs through ``aggregate_pytree``: the
``weighted_aggregate`` kernel for CUDA tensors, its plain version for CPU
ones. An aggregator that is no weighted sum passes a ``combine_fn`` from
the ``[N, D]`` update matrix to one ``[D]`` update, added back onto the
global params.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.weighted_aggregate import aggregate_pytree
from repro_torch.utils import tree_add_vector


def fedavg_weights(sample_counts: torch.Tensor) -> torch.Tensor:
    c = sample_counts.float()
    return c / torch.clamp(c.sum(), min=1e-9)


def accuracy_based_weights(server_accuracies: torch.Tensor,
                           power: float = 1.0) -> torch.Tensor:
    """Accuracies clipped to [0, 1], raised to ``power`` and normalised;
    uniform when they sum to at most 1e-12."""
    a = torch.clamp(server_accuracies.float(), 0.0, 1.0) ** power
    total = a.sum()
    n = a.shape[0]
    return torch.where(total > 1e-12, a / torch.clamp(total, min=1e-12),
                       torch.full_like(a, 1.0 / n))


def aggregate_models(stacked_params, weights: torch.Tensor, *,
                     combine_fn: Optional[Callable] = None,
                     updates: Optional[torch.Tensor] = None,
                     global_params=None):
    """Algorithm 1 line 14: server-side model aggregation.

    Without ``combine_fn``: the weighted sum of ``stacked_params`` (leaves
    with a leading client axis) by the ``[N]`` ``weights``. With it:
    ``combine_fn(updates)`` maps the ``[N, D]`` update matrix to a ``[D]``
    update, added onto ``global_params``; ``weights`` is ignored.
    """
    if combine_fn is None:
        return aggregate_pytree(stacked_params, weights)
    if updates is None or global_params is None:
        raise ValueError(
            "combine_fn aggregation needs the [N, D] updates matrix and "
            "the global params tree")
    return tree_add_vector(global_params, combine_fn(updates))
