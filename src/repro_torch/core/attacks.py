"""Per-client corruption primitives of the malicious-user suite
(counterpart of ``repro/core/attacks.py``); the registered strategies in
``repro_torch.strategies.attacks`` apply them to the malicious slots,
and :func:`apply_attacks` to the last clients of a stack.

``noise`` is the client's list of standard-normal tensors, one per param
leaf in ``tree_leaves`` order, taken from the round's draws.
"""
from __future__ import annotations

import torch

from repro_torch.utils import tree_leaves, tree_map

# the most noise elements the slot-wise attack draws at once
NOISE_SLICE = 1 << 24


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


def _random_weights_slots(noise, stack, scale, clients, slots):
    """:func:`_random_weights` for every slot of a ``[S, ...]`` stack at
    once, bitwise slot by slot: each slot's std over its own leaf, and the
    noise drawn by ``noise.block`` (the population tier's
    ``KeyedNoise`` / ``RecordedNoise``) a leaf at a time in blocks of at
    most ``NOISE_SLICE`` elements (whole rows when a row fits), each used
    at once, so no ``[S, D]`` noise tensor exists."""
    if noise is None:
        raise ValueError("random_weights needs the round's noise draws "
                         "(RoundDraws.noise)")
    leaves = iter(range(1 << 30))        # tree_map walks tree_leaves' order

    def one(t):
        leaf = next(leaves)
        rows, n = t.shape[0], t[0].numel()
        flat = t.reshape(rows, n)
        std = torch.stack([t[s].float().std(correction=0)
                           for s in range(rows)]) + 1e-6
        res = torch.empty_like(flat)
        per = max(1, NOISE_SLICE // n)           # rows a block
        width = min(n, NOISE_SLICE)
        for r0 in range(0, rows, per):
            r1 = min(rows, r0 + per)
            for lo in range(0, n, width):
                hi = min(n, lo + width)
                z = noise.block(leaf, slots[r0:r1], clients[r0:r1], lo, hi)
                res[r0:r1, lo:hi] = (z * std[r0:r1, None] * scale
                                     ).to(t.dtype)
        return res.reshape(t.shape)
    return tree_map(one, stack)


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


# apply_attacks' primitives by name ("none" returns the stack as it is)
_PRIMITIVES = {"random_weights": _random_weights, "sign_flip": _sign_flip,
               "scaled_update": _scaled_update}


def apply_attacks(noise, stacked_params, global_params, *,
                  num_malicious: int, attack: str = "random_weights",
                  scale: float = 1.0):
    """The stack ``[N, ...]`` with its last ``num_malicious`` clients'
    models replaced by attacked ones. ``noise`` is each attacked client's
    list of standard normals in ``tree_leaves`` order, in client order
    (``None`` unless ``attack`` is ``random_weights``); the reference
    draws them from its key here."""
    if num_malicious == 0 or attack == "none":
        return stacked_params
    fn = _PRIMITIVES[attack]
    n = tree_leaves(stacked_params)[0].shape[0]
    bad = range(n - num_malicious, n)
    attacked = [fn(None if noise is None else noise[i],
                   tree_map(lambda a, c=c: a[c], stacked_params),
                   global_params, scale)
                for i, c in enumerate(bad)]

    def merge(stack, *rows):
        out = stack.clone()
        out[n - num_malicious:] = torch.stack(rows)
        return out

    return tree_map(merge, stacked_params, *attacked)
