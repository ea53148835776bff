"""Per-client corruption primitives of the malicious-user suite
(counterpart of ``repro/core/attacks.py``); the registered strategies in
``repro_torch.strategies.attacks`` apply them to the malicious slots.

``noise`` is the client's list of standard-normal tensors, one per param
leaf in ``tree_leaves`` order, taken from the round's draws.
"""
from __future__ import annotations

from repro_torch.utils import tree_map


def _random_weights(noise, trained, reference, scale):
    """Paper's attack: replace the model with random weights of the same
    magnitude statistics as the trained model. The std is the
    population std (``correction=0``), as ``jnp.std`` computes it."""
    if noise is None:
        raise ValueError("random_weights needs the round's noise draws "
                         "(RoundDraws.noise)")
    draws = iter(noise)

    def leaf(t):
        std = t.float().std(correction=0) + 1e-6
        return (next(draws) * std * scale).to(t.dtype)

    return tree_map(leaf, trained)


def _sign_flip(noise, trained, reference, scale):
    """Send global - scale * (trained - global): a gradient-ascent update."""
    return tree_map(
        lambda g, t: (g.float() - scale * (t.float() - g.float())
                      ).to(t.dtype),
        reference, trained)


def _scaled_update(noise, trained, reference, scale):
    """Magnify the local update by ``scale`` (model replacement)."""
    return tree_map(
        lambda g, t: (g.float() + scale * (t.float() - g.float())
                      ).to(t.dtype),
        reference, trained)
