"""Parameter accounting (the port's side of ``repro/models/params.py``).

``count_params_analytic(cfg)`` counts the leaves of the model's param
tree from their shapes (``Model.param_shapes``: ``decoder_specs`` or
``encdec_specs`` for the LMs), allocating nothing, so it counts a 398
B-param config as readily as a small one. With ``active_only`` each MoE expert bank
(``w_gate``, ``w_up``, ``w_down`` under a ``moe`` node) counts
``num_experts_per_tok`` of its ``num_experts`` experts, as the
reference's MODEL_FLOPS terms take it.
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple

_EXPERT_BANKS = ("w_gate", "w_up", "w_down")


def _leaf_sizes_with_paths(tree, path=()) -> Iterator[Tuple[tuple, int]]:
    """(path of keys, size) of each leaf of a nested dict of shapes."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_sizes_with_paths(tree[k], path + (k,))
    else:
        yield path, math.prod(tree)


def count_params_analytic(cfg, active_only: bool = False) -> int:
    from repro_torch.models.model import build_model
    total = 0
    shapes = build_model(cfg).param_shapes()
    for path, size in _leaf_sizes_with_paths(shapes):
        if (active_only and cfg.num_experts and "moe" in path
                and path[-1] in _EXPERT_BANKS):
            size = size * cfg.num_experts_per_tok // cfg.num_experts
        total += size
    return total
