"""Strategy registries of the port (counterpart of ``repro.strategies``).

* :data:`AGGREGATORS` — ``fedtest``, ``fedavg``, ``accuracy_based``,
  ``uniform``, ``krum``, ``trimmed_mean``, ``median`` (weights path);
  ``trimmed_mean_coord``, ``median_coord`` (combine path).
* :data:`ATTACKS`     — ``none``, ``random_weights``, ``sign_flip``,
  ``label_flip_proxy``, ``scaled_update``, ``adaptive_scale``,
  ``scaled_collusion``.
* :data:`SELECTORS`   — ``rotating``, ``uniform``, ``round_robin``,
  ``coverage``, ``score_weighted``, ``fixed``.
* :data:`COALITIONS`  — ``none``, ``mutual_boost``, ``sybil_split``,
  ``full_collusion``.
* :data:`FAULTS`      — ``none``, ``dropout``, ``straggler_deadline``,
  ``targeted``.
* :data:`COMPRESSORS` — ``identity``, ``topk``, ``int8``, ``lowrank``.
"""
from repro_torch.strategies.base import (
    AGGREGATORS, ATTACKS, COALITIONS, FAULTS, SELECTORS, Aggregator, Attack,
    AttackContext, Fault, Registry, RoundContext, Selector, register,
    resolve_placement, uses_combine)
# importing the submodules populates the registries
from repro_torch.strategies import aggregators as _aggregators  # noqa: F401
from repro_torch.strategies import attacks as _attacks          # noqa: F401
from repro_torch.strategies import faults as _faults            # noqa: F401
from repro_torch.strategies import selectors as _selectors      # noqa: F401
from repro_torch.strategies.coalition import Coalition, CoalitionAttack
from repro_torch.strategies.compressors import COMPRESSORS, Compressor

__all__ = [
    "AGGREGATORS", "ATTACKS", "COALITIONS", "COMPRESSORS", "FAULTS",
    "SELECTORS", "Aggregator", "Attack", "AttackContext", "Coalition",
    "CoalitionAttack", "Compressor", "Fault", "Registry", "RoundContext",
    "Selector", "register", "resolve_placement", "uses_combine",
]
