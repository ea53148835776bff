"""Strategy registries of the port (counterpart of ``repro.strategies``).

* :data:`AGGREGATORS` — ``fedtest``, ``fedavg``, ``uniform``.
* :data:`ATTACKS`     — ``none``, ``random_weights``, ``sign_flip``,
  ``scaled_update``.
* :data:`SELECTORS`   — ``rotating``, ``uniform``.

A name the reference registers and the port does not yet raises with the
``ROADMAP.md`` item that ports it.
"""
from repro_torch.strategies.base import (
    AGGREGATORS, ATTACKS, SELECTORS, Aggregator, Attack, AttackContext,
    Registry, RoundContext, Selector, register, resolve_placement)
# importing the submodules populates the registries
from repro_torch.strategies import aggregators as _aggregators  # noqa: F401
from repro_torch.strategies import attacks as _attacks          # noqa: F401
from repro_torch.strategies import selectors as _selectors      # noqa: F401

__all__ = [
    "AGGREGATORS", "ATTACKS", "SELECTORS", "Aggregator", "Attack",
    "AttackContext", "Registry", "RoundContext", "Selector", "register",
    "resolve_placement",
]
