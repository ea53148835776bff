"""Registered malicious-client strategies (counterpart of
``repro/strategies/attacks.py``).

* ``none``           — honest run (also what ``num_malicious=0`` means).
* ``random_weights`` — the paper's attack (Sec. IV): random weights with
  the trained model's per-leaf magnitude statistics.
* ``sign_flip``      — gradient-ascent update ``g - scale*(t - g)``.
* ``label_flip_proxy`` — update-space proxy for label flipping: the
  sign-flipped update at unit scale, so its magnitude looks honest.
* ``scaled_update``  — model-replacement magnification ``g + scale*(t - g)``.
* ``adaptive_scale`` — the sign-flip at ``scale`` while the attacker's own
  implied weight is at least ``weight_threshold / N``, else the honest
  update, so that the testers rebuild its score.
* ``scaled_collusion`` — sybil-split poisoning: each malicious client sends
  its ``1/split`` share of one sign-flip poison at ``scale``.
"""
from __future__ import annotations

import torch

from repro_torch.core.attacks import (
    _random_weights, _random_weights_slots, _scaled_update, _sign_flip)
from repro_torch.strategies.base import ATTACKS, Attack, register
from repro_torch.utils import tree_map


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

    def corrupt_slots(self, noise, stack, global_params, ctx, clients,
                      slots):
        return _random_weights_slots(noise, stack, self.scale, clients,
                                     slots)


@register(ATTACKS, "sign_flip")
class SignFlip(Attack):
    """Gradient-ascent update: ``global - scale * (trained - global)``."""

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        return _sign_flip(key, trained, global_params, self.scale)


@register(ATTACKS, "label_flip_proxy")
class LabelFlipProxy(Attack):
    """Label-flipping poisoning, approximated in update space: the
    sign-flipped update at unit scale (the ``scale`` offered is
    discarded, so the magnitude matches an honest client's)."""

    def __init__(self, *, num_malicious: int = 0, scale: float = 1.0,
                 placement: str = "last", indices=None):
        super().__init__(num_malicious=num_malicious, scale=1.0,
                         placement=placement, indices=indices)

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        return _sign_flip(key, trained, global_params, 1.0)


@register(ATTACKS, "scaled_collusion")
class ScaledCollusion(Attack):
    """Sybil-split model poisoning (DESIGN.md §7): each malicious client
    sends ``g - (scale/split)·(t - g)``, its even share of one full-scale
    sign-flip poison. ``split`` defaults to the malicious-set size, so no
    single update deviates more than a ``scale/split`` attacker's while
    the coalition's sum rebuilds the whole poison. The ``sybil_split`` and
    ``full_collusion`` coalitions run it over their members."""

    def __init__(self, *, num_malicious: int = 0, scale: float = 8.0,
                 placement: str = "last", indices=None, split: int = 0):
        super().__init__(num_malicious=num_malicious, scale=scale,
                         placement=placement, indices=indices)
        if split < 0:
            raise ValueError(f"split must be >= 0, got {split}")
        self.split = int(split) if split else max(1, self.num_malicious)

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        return _sign_flip(key, trained, global_params,
                          self.scale / self.split)


@register(ATTACKS, "scaled_update")
class ScaledUpdate(Attack):
    """Model replacement: magnify the local update by ``scale``."""

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        return _scaled_update(key, trained, global_params, self.scale)


@register(ATTACKS, "adaptive_scale")
class AdaptiveScale(Attack):
    """Adaptive attacker that reads its own implied weight from the
    :class:`AttackContext`: at or above ``weight_threshold / N`` it sends
    the sign-flip at ``scale``, below it the honest trained model. The
    choice is a ``torch.where`` on the device, so the round never waits
    for the host. Without a context it always sign-flips."""

    def __init__(self, *, num_malicious: int = 0, scale: float = 4.0,
                 weight_threshold: float = 0.5, placement: str = "last",
                 indices=None):
        super().__init__(num_malicious=num_malicious, scale=scale,
                         placement=placement, indices=indices)
        if not 0.0 <= weight_threshold:
            raise ValueError(
                f"weight_threshold must be >= 0, got {weight_threshold}")
        self.weight_threshold = float(weight_threshold)

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        bad = _sign_flip(key, trained, global_params, self.scale)
        if ctx is None or client_idx is None:
            return bad
        # a host int, or the population tier's [S] slot clients
        engaged = (ctx.weights[client_idx]
                   >= self.weight_threshold / ctx.num_users)

        def pick(t, b):
            on = engaged.reshape(engaged.shape
                                 + (1,) * (t.dim() - engaged.dim()))
            return torch.where(on, b.to(t.dtype), t)
        return tree_map(pick, trained, bad)
