"""Registered tester-selection policies (Algorithm 1 line 16), counterpart
of ``repro/strategies/selectors.py``.

* ``rotating``       — independent random K-subset per round (the
  paper's scheme).
* ``uniform``        — alias of ``rotating`` under the taxonomy name.
* ``round_robin``    — deterministic contiguous blocks walking the client
  ring: round r tests ``(r*K + 0..K-1) mod N``.
* ``coverage``       — a permutation of the clients a cycle of ``ceil(N/K)``
  rounds, consumed in K-blocks: everyone tests once a cycle, in an order
  a coalition cannot predict.
* ``score_weighted`` — a Gumbel top-k draw without replacement, with
  probabilities proportional to the scores entering the round.
* ``fixed``          — a pinned committee (clients 0..K-1, or ``indices``).

Each random policy splits into a draw and a pure function of what it
drew (:func:`coverage_ids`, :func:`score_weighted_ids`), so that the
parity tests can feed the pure step the reference's draws.

``round_idx`` is the host int of a single round or, in a chunk of rounds
(``FederatedTrainer.run_chunk``), a 0-d int64 counter on the device that
a CUDA graph of the round reads: every policy builds its ids on the
generator's device with no copy from the host, ``coverage`` from the
permutations its :meth:`~Coverage.schedule` loads before the chunk.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.selection import select_testers
from repro_torch.strategies.base import SELECTORS, Selector, register
from repro_torch.utils import derived_seed


def _device(key) -> torch.device:
    return key.device if key is not None else torch.device("cpu")


@register(SELECTORS, "rotating")
class Rotating(Selector):
    """Random K-subset, redrawn each round from the round's generator."""

    def select(self, key, num_users, num_testers, round_idx, *,
               scores=None):
        return select_testers(key, num_users, num_testers, round_idx)


@register(SELECTORS, "uniform")
class UniformDraw(Rotating):
    """Alias of ``rotating``."""


@register(SELECTORS, "round_robin")
class RoundRobin(Selector):
    """Deterministic block rotation: round r tests clients
    ``(r*K + 0..K-1) mod N``."""

    def select(self, key, num_users, num_testers, round_idx, *,
               scores=None):
        start = (round_idx * num_testers) % num_users
        ids = (start + torch.arange(num_testers, device=_device(key))
               ) % num_users
        return ids.to(torch.int32)


def coverage_ids(perm: torch.Tensor, round_idx, num_testers: int
                 ) -> torch.Tensor:
    """Round ``round_idx``'s K-block of its cycle's permutation ``perm``
    ``[N]``, wrapping past the end of it."""
    num_users = perm.shape[0]
    cycle_len = -(-num_users // num_testers)        # ceil(N/K)
    start = (round_idx % cycle_len) * num_testers
    return perm[(start + torch.arange(num_testers, device=perm.device))
                % num_users]


@register(SELECTORS, "coverage")
class Coverage(Selector):
    """Randomised coverage: a shuffled round robin. Each cycle of
    ``ceil(N/K)`` rounds walks one permutation of the ids, drawn by a CPU
    generator seeded from ``(seed, cycle)`` alone, so the schedule is the
    same on the CPU and the card and never touches the round's
    generator."""

    def __init__(self, *, seed: int = 0):
        self.seed = int(seed)
        # a chunk's permutations on the device, [cycles, N], and the
        # first cycle they hold (a 0-d device tensor), from schedule()
        self._perms = self._first_cycle = None

    def cycle_permutation(self, cycle: int, num_users: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(derived_seed(self.seed, cycle))
        return torch.randperm(num_users, generator=gen)

    def schedule(self, first_round, num_rounds, num_users, num_testers,
                 device):
        """Load the permutations of every cycle that rounds
        ``first_round`` .. ``first_round + num_rounds - 1`` touch into
        one device buffer, the same buffer every chunk of that length."""
        cycle_len = -(-num_users // num_testers)
        first = first_round // cycle_len
        span = -(-num_rounds // cycle_len) + 1      # the most cycles touched
        perms = torch.stack([self.cycle_permutation(c, num_users)
                             for c in range(first, first + span)])
        if self._perms is None or self._perms.shape != perms.shape:
            self._perms = torch.empty(perms.shape, dtype=perms.dtype,
                                      device=device)
            self._first_cycle = torch.zeros((), dtype=torch.int64,
                                            device=device)
        self._perms.copy_(perms)
        self._first_cycle.fill_(first)

    def select(self, key, num_users, num_testers, round_idx, *,
               scores=None):
        cycle = round_idx // -(-num_users // num_testers)
        if isinstance(round_idx, torch.Tensor):
            # a chunk's round: its cycle's row of the scheduled buffer
            row = (cycle - self._first_cycle).reshape(1)
            perm = self._perms.index_select(0, row)[0]
        else:
            perm = self.cycle_permutation(cycle, num_users).to(_device(key))
        return coverage_ids(perm, round_idx, num_testers).to(torch.int32)


def score_weighted_ids(scores: Optional[torch.Tensor], u: torch.Tensor,
                       num_testers: int, eps: float) -> torch.Tensor:
    """Gumbel top-k over ``log(max(scores, 0) + eps)`` with the uniforms
    ``u [N]`` in ``[1e-12, 1)`` (uniform weights when ``scores`` is
    None): K ids without replacement, int32."""
    if scores is None:
        p = torch.ones_like(u)
    else:
        p = torch.clamp(scores.float(), min=0.0) + eps
    gumbel = -torch.log(-torch.log(u))
    return torch.topk(torch.log(p) + gumbel, num_testers).indices.to(
        torch.int32)


@register(SELECTORS, "score_weighted")
class ScoreWeighted(Selector):
    """Trust-proportional testers: P(c tests) ∝ scores[c] + eps. Before
    any scores exist (all zero) the draw is uniform through ``eps``."""

    def __init__(self, *, eps: float = 1e-3):
        if eps <= 0.0:
            raise ValueError(f"eps must be > 0, got {eps}")
        self.eps = float(eps)

    def select(self, key, num_users, num_testers, round_idx, *,
               scores=None):
        # uniform in [1e-12, 1), as jax.random.uniform(minval=1e-12) maps it
        u = torch.rand((num_users,), generator=key, device=key.device)
        u = torch.clamp(u * (1.0 - 1e-12) + 1e-12, min=1e-12)
        return score_weighted_ids(scores, u, num_testers, self.eps)


@register(SELECTORS, "fixed")
class Fixed(Selector):
    """A pinned tester committee."""

    def __init__(self, *, indices: Optional[Tuple[int, ...]] = None):
        self.indices = (tuple(int(i) for i in indices)
                        if indices is not None else None)
        self._ids = {}      # device -> the indices there, made once

    def select(self, key, num_users, num_testers, round_idx, *,
               scores=None):
        device = _device(key)
        if self.indices is None:
            return torch.arange(num_testers, dtype=torch.int32,
                                device=device)
        if len(self.indices) != num_testers:
            raise ValueError(
                f"fixed selector got {len(self.indices)} indices but "
                f"num_testers={num_testers}")
        # copied from the host at the first round on a device (a chunk's
        # warm-up round, outside its capture), reused after
        if device not in self._ids:
            self._ids[device] = torch.tensor(self.indices, dtype=torch.int32,
                                             device=device)
        return self._ids[device]
