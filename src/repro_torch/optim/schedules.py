"""Learning-rate schedules: pure functions of the step counter.

``step`` is a 0-d integer tensor (batched under ``vmap``); the rate comes
back as an fp32 tensor, computed in fp32 as the reference does.
"""
from __future__ import annotations

import math

import torch


def make_schedule(cfg):
    """cfg: TrainConfig -> (step tensor -> lr tensor)."""
    base = cfg.lr
    warmup = max(cfg.warmup_steps, 0)
    total = max(cfg.total_steps, 1)

    if cfg.schedule == "constant":
        def sched(step):
            return torch.zeros_like(step, dtype=torch.float32) + base
    elif cfg.schedule == "cosine":
        def sched(step):
            frac = torch.clamp(step.float() / total, 0.0, 1.0)
            return base * 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear_warmup_cosine":
        def sched(step):
            s = step.float()
            wu = torch.clamp(s / max(warmup, 1), 0.0, 1.0)
            frac = torch.clamp((s - warmup) / max(total - warmup, 1),
                               0.0, 1.0)
            return base * wu * 0.5 * (1.0 + torch.cos(math.pi * frac))
    else:
        raise ValueError(cfg.schedule)
    return sched
