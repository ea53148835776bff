"""Registered client-failure models (DESIGN.md §9), counterpart of
``repro/strategies/faults.py``.

Each model gives a per-round ``[N]`` 0/1 survival mask that the engine
ANDs into the participation mask after selection, so a dropped client
gets the non-sampled semantics: zero weight, a frozen score, a masked
report row. Each is split into a draw from the round's generator and a
pure mask of those draws (:class:`~repro_torch.strategies.base.Fault`),
so the parity tests can hand the mask the reference's ``keys.fault``
draws.

* ``none``               — no failures (never called: the engine skips the
  seam when ``FedConfig.fault`` is ``none``).
* ``dropout``            — i.i.d. Bernoulli failures at ``rate``: ``[N]``
  uniforms, a client survives where its uniform is below ``1 - rate``
  (``jax.random.bernoulli`` is that comparison, so the reference's
  uniforms give its mask exactly).
* ``straggler_deadline`` — client c's latency is ``mean_c * jitter_c``
  with ``mean_c = 1 + spread * c / (N - 1)`` and ``[N]`` Exponential(1)
  jitters; a client over ``deadline`` is dropped.
* ``targeted``           — the placed index set is dropped every round
  from ``start_round`` on; it draws nothing. ``round_idx`` is the host
  int or a chunk's device counter.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.strategies.base import (
    FAULTS, Fault, normalize_placement, placement_mask, register,
    resolve_placement)


@register(FAULTS, "none")
class NoFault(Fault):
    """Every client survives every round."""

    def mask(self, draws, num_users, round_idx, device=None):
        return torch.ones((num_users,), dtype=torch.float32, device=device)


@register(FAULTS, "dropout")
class Dropout(Fault):
    """I.i.d. per-round Bernoulli client failures at ``rate``."""

    def __init__(self, *, rate: float = 0.1):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate in [0, 1), got {rate}")
        self.rate = float(rate)

    def draw(self, gen, num_users):
        return torch.rand((num_users,), generator=gen, device=gen.device)

    def mask(self, draws, num_users, round_idx, device=None):
        return (draws < 1.0 - self.rate).float()


@register(FAULTS, "straggler_deadline")
class StragglerDeadline(Fault):
    """Clients slower than ``deadline`` this round are dropped; client 0
    is the fastest on average, client N-1 the slowest (``spread``)."""

    def __init__(self, *, deadline: float = 2.5, spread: float = 1.0):
        if deadline <= 0.0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        if spread < 0.0:
            raise ValueError(f"spread must be >= 0, got {spread}")
        self.deadline = float(deadline)
        self.spread = float(spread)

    def draw(self, gen, num_users):
        return torch.empty((num_users,), device=gen.device).exponential_(
            generator=gen)

    def mask(self, draws, num_users, round_idx, device=None):
        rank = torch.arange(num_users, dtype=torch.float32,
                            device=draws.device)
        mean = 1.0 + self.spread * rank / max(num_users - 1, 1)
        return (mean * draws <= self.deadline).float()


@register(FAULTS, "targeted")
class Targeted(Fault):
    """Placement-aware drops: the placed set fails every round from
    ``start_round`` on (an adversarial partition or DoS)."""

    def __init__(self, *, size: int = 0, placement: str = "last",
                 indices: Optional[Tuple[int, ...]] = None,
                 start_round: int = 0):
        self.size, self.placement, self._indices = normalize_placement(
            size, placement, indices)
        if start_round < 0:
            raise ValueError(
                f"start_round must be >= 0, got {start_round}")
        self.start_round = int(start_round)

    def target_indices(self, num_users: int) -> Tuple[int, ...]:
        return resolve_placement(num_users, self.size, self.placement,
                                 self._indices)

    def mask(self, draws, num_users, round_idx, device=None):
        dropped = placement_mask(num_users, self.target_indices(num_users),
                                 device)
        # a bool or a 0-d device bool: nothing is read to the host
        return 1.0 - dropped * (round_idx >= self.start_round)
