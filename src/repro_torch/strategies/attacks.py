"""Registered malicious-client strategies (the entries of
``repro/strategies/attacks.py`` that this slice runs).

* ``none``           — honest run (also what ``num_malicious=0`` means).
* ``random_weights`` — the paper's attack (Sec. IV): random weights with
  the trained model's per-leaf magnitude statistics.
* ``sign_flip``      — gradient-ascent update ``g - scale*(t - g)``.
* ``scaled_update``  — model-replacement magnification ``g + scale*(t - g)``.
"""
from __future__ import annotations

from repro_torch.core.attacks import (
    _random_weights, _scaled_update, _sign_flip)
from repro_torch.strategies.base import ATTACKS, Attack, register


@register(ATTACKS, "none")
class NoAttack(Attack):
    """Honest federation. Reports an empty malicious set even when
    ``num_malicious`` is set, so ``malicious_weight`` reads 0."""

    def malicious_indices(self, num_users):
        return ()

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        return trained


@register(ATTACKS, "random_weights")
class RandomWeights(Attack):
    """Paper Sec. IV: malicious users send random weights."""

    needs_noise = True

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        return _random_weights(key, trained, global_params, self.scale)


@register(ATTACKS, "sign_flip")
class SignFlip(Attack):
    """Gradient-ascent update: ``global - scale * (trained - global)``."""

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        return _sign_flip(key, trained, global_params, self.scale)


@register(ATTACKS, "scaled_update")
class ScaledUpdate(Attack):
    """Model replacement: magnify the local update by ``scale``."""

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        return _scaled_update(key, trained, global_params, self.scale)
