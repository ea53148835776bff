"""Exchange backends (counterpart of ``repro/core/engine/backends.py``).

Only the ``local`` backend is ported: the N client models are a stacked
``[N, ...]`` param tree on one device, local training, cross-testing
(``batched``, or the ``reference`` loop) and the server's eval run under
``torch.func.vmap`` over the client axis, and aggregation is the
``weighted_aggregate`` kernel, one launch a table of param leaves. The
backend also builds the ``[N, D]`` f32 update matrix and runs the
compressed exchange (encode with error feedback, decode, and the
weighted sum in update space). The ring and all-gather pod backends are
ROADMAP.md queue 1 item 15.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from repro_torch.core.cross_testing import (
    CROSSTEST_IMPLS, cross_test_accuracies)
from repro_torch.kernels.weighted_aggregate import aggregate_pytree
from repro_torch.utils import tree_add_vector, tree_leaves, tree_map


def _flatten_updates(stacked, global_params) -> torch.Tensor:
    """[N, D] float32 matrix of flattened client updates (``tree_leaves``
    order, each leaf raveled)."""
    parts = tree_leaves(tree_map(
        lambda s, g: (s.float() - g.float()[None]).reshape(s.shape[0], -1),
        stacked, global_params))
    return torch.cat(parts, dim=1)


class LocalBackend:
    """Single-device backend: clients stacked on a leading [N] axis."""

    name = "local"

    def __init__(self, num_users: int, crosstest_impl: str = "batched"):
        if crosstest_impl not in CROSSTEST_IMPLS:
            raise ValueError(f"crosstest_impl must be one of "
                             f"{CROSSTEST_IMPLS}, got {crosstest_impl!r}")
        self.num_users = num_users
        self.crosstest_impl = crosstest_impl

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
        return cross_test_accuracies(eval_fn, models, tx[ids], ty[ids],
                                     impl=self.crosstest_impl)

    def server_eval(self, eval_fn, models, sx, sy):
        """Step 6: a closure giving every client model's accuracy [N] on
        the server's held-out set."""
        return lambda: vmap(lambda p: eval_fn(p, sx, sy))(models)

    def updates(self, models, global_params):
        """The [N, D] float32 flattened update matrix."""
        return _flatten_updates(models, global_params)

    def weighted_sum(self, models, weights, global_params):
        """Step 7: sum_c w_c * model_c -> new global."""
        return aggregate_pytree(models, weights)

    def compress_exchange(self, compressor, models, global_params,
                          comp_state, part_mask):
        """Step 3c: encode every client's flat update with error feedback
        (all rows at once, each with one row's arithmetic) and rebuild
        the models from the decoded updates. Returns ``(models, payloads,
        decoded, new_comp_state)``."""
        updates = _flatten_updates(models, global_params)       # [N, D]
        payloads, new_state = compressor.encode(comp_state, updates)
        decoded = compressor.decode(payloads)                   # [N, D]
        if part_mask is not None:
            # a masked client transmitted nothing: its error buffer must
            # not be flushed and its decoded update is exactly 0, so its
            # rebuilt slot is the stale global model
            keep = (part_mask > 0)[:, None]
            new_state = torch.where(keep, new_state, comp_state)
            decoded = torch.where(keep, decoded, 0.0)
        models = tree_add_vector(global_params, decoded)
        return models, payloads, decoded, new_state

    def compressed_sum(self, compressor, payloads, decoded, weights):
        """Step 7, compressed: ``sum_c w_c * decoded_c`` -> flat [D] f32."""
        return compressor.aggregate(payloads, decoded, weights)
