"""Functional optimizers over param dicts: SGD / momentum / Adam / AdamW,
with global-norm grad clipping (counterpart of ``repro/optim/optimizer.py``).

``update(grads, state, params) -> (params, state)`` is a pure function of
one model's trees, so the round engine drives it per client under
``torch.func.vmap``. All float math runs in fp32 and casts back to the
param dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.optim.schedules import make_schedule
from repro_torch.utils import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]
    name: str = ""


def _clip(grads, max_norm):
    if not max_norm or max_norm <= 0:
        return grads
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _zeros32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_optimizer(cfg) -> Optimizer:
    """cfg: TrainConfig."""
    sched = make_schedule(cfg)

    if cfg.optimizer == "sgd":
        def init(params):
            return {"step": _step0(params)}

        def update(grads, state, params):
            grads = _clip(grads, cfg.grad_clip)
            lr = sched(state["step"])
            new = tree_map(lambda p, g: (p.float() - lr * g.float()
                                         ).to(p.dtype), params, grads)
            return new, {"step": state["step"] + 1}
        return Optimizer(init, update, "sgd")

    if cfg.optimizer == "momentum":
        def init(params):
            return {"step": _step0(params), "mu": _zeros32(params)}

        def update(grads, state, params):
            grads = _clip(grads, cfg.grad_clip)
            lr = sched(state["step"])
            mu = tree_map(lambda m, g: cfg.momentum * m + g.float(),
                          state["mu"], grads)
            new = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                           params, mu)
            return new, {"step": state["step"] + 1, "mu": mu}
        return Optimizer(init, update, "momentum")

    if cfg.optimizer in ("adam", "adamw"):
        wd = cfg.weight_decay if cfg.optimizer == "adamw" else 0.0

        def init(params):
            return {"step": _step0(params), "m": _zeros32(params),
                    "v": _zeros32(params)}

        def update(grads, state, params):
            grads = _clip(grads, cfg.grad_clip)
            step = state["step"] + 1
            lr = sched(state["step"])
            b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
            m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                         state["m"], grads)
            v = tree_map(lambda v_, g: b2 * v_
                         + (1 - b2) * torch.square(g.float()),
                         state["v"], grads)
            bc1 = 1 - torch.pow(b1, step.float())
            bc2 = 1 - torch.pow(b2, step.float())

            def upd(p, m_, v_):
                # the reference's arithmetic, op for op, in place on
                # fresh temporaries: a leaf's step holds two f32 copies
                # of it, not four (4 clients' stacked expert banks are
                # 3 GiB each in f32)
                u = (m_ / bc1).div_((v_ / bc2).sqrt_().add_(eps))
                if wd:
                    u.add_(p.to(torch.float32, copy=True).mul_(wd))
                return (p.to(torch.float32, copy=True).sub_(u.mul_(lr))
                        .to(p.dtype))

            new = tree_map(upd, params, m, v)
            return new, {"step": step, "m": m, "v": v}
        return Optimizer(init, update, cfg.optimizer)

    raise ValueError(cfg.optimizer)
