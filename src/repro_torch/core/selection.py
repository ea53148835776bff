"""Tester selection (Algorithm 1 line 16), counterpart of
``repro/core/selection.py``: a uniform K-subset drawn as top-k over
i.i.d. uniforms. ``torch.topk`` and ``jax.lax.top_k`` both return the
indices in descending order of value, so equal uniforms give equal ids.
"""
from __future__ import annotations

import torch


def pick_testers(u: torch.Tensor, num_testers: int
                          ) -> torch.Tensor:
    """[N] uniforms -> the [K] int32 ids of the K largest."""
    return torch.topk(u, num_testers).indices.to(torch.int32)


def select_testers(gen: torch.Generator, num_users: int, num_testers: int,
                   round_idx: int) -> torch.Tensor:
    """Rotating K-subset, an independent draw per round. The generator's
    stream advances every round, so ``round_idx`` needs no fold-in; it
    stays in the signature the selectors share."""
    u = torch.rand((num_users,), generator=gen, device=gen.device)
    return pick_testers(u, num_testers)
