"""The step functions the dry-run runs (the port's side of
``repro/launch/steps.py``).

The train step differentiates ``Model.loss(..., remat=)`` with
``torch.autograd.grad`` over the params as leaves that require a
gradient (``torch.func.grad`` refuses the saved-tensor hooks of a
non-reentrant ``torch.utils.checkpoint``), then takes the port's
``make_optimizer`` update without a graph. Prefill and decode run
without one.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.optim import make_optimizer
from repro_torch.utils import tree_leaves, tree_map


def _like(grad, param):
    placements = getattr(param, "placements", None)
    if placements is None or tuple(grad.placements) == tuple(placements):
        return grad
    return grad.redistribute(param.device_mesh, placements)


def make_train_step(model, train_cfg: TrainConfig):
    opt = make_optimizer(train_cfg)

    def train_step(params, opt_state, batch
                   ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = model.loss(leaves, batch, remat=train_cfg.remat)
            flat = torch.autograd.grad(loss, tree_leaves(leaves))
        it = iter(flat)
        # each grad onto its param's placements (a DTensor's partial sums
        # reduce-scattered, as FSDP does); a plain tensor's stays
        grads = tree_map(lambda p: _like(next(it), p), params)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach())

    return train_step, opt


def make_prefill_step(model, cache_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len=cache_len)
    return prefill_step


def make_decode_step(model):
    @torch.no_grad()
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch["tokens"])
    return decode_step
