"""Registered tester-selection policies (Algorithm 1 line 16).

* ``rotating`` — independent random K-subset per round (the paper's
  scheme).
* ``uniform``  — alias of ``rotating`` under the taxonomy name.
"""
from __future__ import annotations

from repro_torch.core.selection import select_testers
from repro_torch.strategies.base import SELECTORS, Selector, register


@register(SELECTORS, "rotating")
class Rotating(Selector):
    """Random K-subset, redrawn each round from the round's generator."""

    def select(self, key, num_users, num_testers, round_idx, *,
               scores=None):
        return select_testers(key, num_users, num_testers, round_idx)


@register(SELECTORS, "uniform")
class UniformDraw(Rotating):
    """Alias of ``rotating``."""
