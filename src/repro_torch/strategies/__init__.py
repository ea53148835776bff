"""Strategy registries of the port (counterpart of ``repro.strategies``).

* :data:`AGGREGATORS` — ``fedtest``, ``fedavg``, ``accuracy_based``,
  ``uniform``, ``krum``, ``trimmed_mean``, ``median`` (weights path);
  ``trimmed_mean_coord``, ``median_coord`` (combine path).
* :data:`ATTACKS`     — ``none``, ``random_weights``, ``sign_flip``,
  ``label_flip_proxy``, ``scaled_update``, ``adaptive_scale``.
* :data:`SELECTORS`   — ``rotating``, ``uniform``, ``round_robin``,
  ``coverage``, ``score_weighted``, ``fixed``.
* :data:`COMPRESSORS` — ``identity``, ``topk``, ``int8``, ``lowrank``.

A name the reference registers and the port does not yet raises with the
``ROADMAP.md`` item that ports it.
"""
from repro_torch.strategies.base import (
    AGGREGATORS, ATTACKS, SELECTORS, Aggregator, Attack, AttackContext,
    Registry, RoundContext, Selector, register, resolve_placement,
    uses_combine)
# importing the submodules populates the registries
from repro_torch.strategies import aggregators as _aggregators  # noqa: F401
from repro_torch.strategies import attacks as _attacks          # noqa: F401
from repro_torch.strategies import selectors as _selectors      # noqa: F401
from repro_torch.strategies.compressors import COMPRESSORS, Compressor

__all__ = [
    "AGGREGATORS", "ATTACKS", "COMPRESSORS", "SELECTORS", "Aggregator",
    "Attack", "AttackContext", "Compressor", "Registry", "RoundContext",
    "Selector", "register", "resolve_placement", "uses_combine",
]
