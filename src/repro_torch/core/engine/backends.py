"""Exchange backends (counterpart of ``repro/core/engine/backends.py``).

Only the ``local`` backend is ported: the N client models are a stacked
``[N, ...]`` param tree on one device, local training and cross-testing
run under ``torch.func.vmap`` over the client axis, and aggregation is
the ``weighted_aggregate`` kernel, one launch per param leaf. The ring
and all-gather pod backends are ROADMAP.md queue 1 item 15.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from repro_torch.core.cross_testing import cross_test_batched
from repro_torch.kernels.weighted_aggregate import aggregate_pytree
from repro_torch.utils import tree_map


class LocalBackend:
    """Single-device backend: clients stacked on a leading [N] axis."""

    name = "local"

    def __init__(self, num_users: int):
        self.num_users = num_users

    def train(self, local_train, global_params, bx, by):
        """Broadcast + local phase -> (models, per-client losses [N])."""
        stacked = tree_map(
            lambda x: x[None].expand((self.num_users,) + x.shape),
            global_params)
        return vmap(local_train)(stacked, bx, by)

    def apply_attack(self, attack, noise, models, global_params, actx):
        """Step 3: corrupt the malicious clients' models."""
        return attack.apply(noise, models, global_params, actx)

    def mask_models(self, models, global_params, part_mask):
        """Step 3b: revert non-participants' slots to the global model."""
        return tree_map(
            lambda t, g: torch.where(
                part_mask.reshape((-1,) + (1,) * (t.dim() - 1)) > 0,
                t, g[None].to(t.dtype)),
            models, global_params)

    def cross_test(self, eval_fn, models, tx, ty, tester_ids):
        """Step 4: the [K, N] accuracy matrix."""
        ids = tester_ids.long()
        return cross_test_batched(eval_fn, models, tx[ids], ty[ids])

    def weighted_sum(self, models, weights, global_params):
        """Step 7: sum_c w_c * model_c -> new global."""
        return aggregate_pytree(models, weights)
