"""Seeds derived from a run's seed, for draws that must not come from the
round's carried generator (a schedule that is a pure function of the run
seed and a counter, so a resumed run draws what an unbroken one does),
and a counter-based normal draw keyed on the device.

:func:`keyed_normal` is Philox-4x32-10 (Salmon et al., SC 2011) in plain
torch integer ops, then Box-Muller in f32: a pure function of its key and
counter, drawing from no ``torch.Generator``, so a round that names its
counter with device tensors (a client id, a chunk's round counter) draws
inside a CUDA graph. The 32-bit words live in int64 tensors and every
product is formed from 16-bit limbs, so no operation leaves int64's
range: the integers are the same on the CPU and the card, and the
normals agree to the last ulp of ``log`` / ``cos`` / ``sin``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# Philox-4x32's multipliers and Weyl key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10
# keyed_normal draws whole multiples of this many quads (64 elements)
QUAD_PAD = 16


def derived_seed(*parts: int) -> int:
    """A 63-bit ``torch.Generator`` seed that is a pure function of the
    non-negative integers ``parts`` (numpy's ``SeedSequence`` mixes them),
    the same in every process."""
    lo, hi = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return int(lo) | (int(hi) & 0x7FFFFFFF) << 32


def philox_key(*parts: int) -> Tuple[int, int]:
    """The two 32-bit Philox key words of :func:`derived_seed` of
    ``parts``."""
    seed = derived_seed(*parts)
    return seed & MASK32, seed >> 32


def _mulhilo(a, m: int):
    """The high and low 32-bit words of ``a * m`` for ``a`` in [0, 2**32)
    (an int64 tensor) and a 32-bit constant ``m``, from ``m``'s 16-bit
    limbs: each partial product stays below 2**48."""
    p = a * (m & 0xFFFF)
    q = a * (m >> 16)
    lo = (p + ((q & 0xFFFF) << 16)) & MASK32
    hi = (q + (p >> 16)) >> 16
    return hi, lo


def philox4x32(counter, key):
    """Philox-4x32-10 of the four counter words (int64 tensors or ints in
    [0, 2**32), broadcast together) under the two key words (ints, or
    0-d int64 tensors); returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit word -> an f32 uniform in (0, 1): its top 23 bits, odd
    multiples of 2**-24 (exact in f32, never 0)."""
    return ((x >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24


def box_muller(x) -> torch.Tensor:
    """The four Philox words ``x`` of each of ``[rows, quads]`` counters
    -> ``[rows, 4 * quads]`` f32 standard normals: element i is lane
    ``i % 4`` of quad ``i // 4``, lanes 0, 1 and 2, 3 each a Box-Muller
    pair. The float ops run on contiguous ``[rows, quads]`` tensors (the
    first integer op makes a strided ``x`` dense), so with ``quads`` a
    multiple of ``QUAD_PAD`` an element's value on the CPU does not
    depend on the row it sits in."""
    out = []
    for a, b in ((x[0], x[1]), (x[2], x[3])):
        r = torch.sqrt(-2.0 * torch.log(_uniform(a)))
        theta = (2.0 * np.pi) * _uniform(b)
        out += [r * torch.cos(theta), r * torch.sin(theta)]
    z = torch.stack(out, dim=-1)                   # [rows, quads, 4]
    return z.reshape(z.shape[0], -1)


def padded_quads(elements: int) -> int:
    """The quads that hold ``elements`` normals, padded to a multiple of
    ``QUAD_PAD``: on the CPU a tensor's tail past its last full vector
    takes the scalar ``log`` and ``cos``, which round otherwise than the
    vectorised ones, so every element takes the vectorised path whatever
    the slice."""
    quads = -(-elements // 4)
    return -(-quads // QUAD_PAD) * QUAD_PAD


def keyed_normal(key, words, lo: int, hi: int, device=None
                 ) -> torch.Tensor:
    """Standard normals ``[rows, hi - lo]`` of the elements ``lo..hi`` of
    a stream named by ``words``, three counter words (int64 device
    tensors of shape ``[rows, 1]`` or ``[]``, or ints), under the Philox
    ``key``. Element i is lane ``i % 4`` of counter ``(i // 4, *words)``
    (:func:`box_muller`), so an element's value does not depend on the
    slice that draws it. ``lo`` is a multiple of 4; the quads are padded
    (:func:`padded_quads`)."""
    if lo % 4:
        raise ValueError(f"lo must be a multiple of 4, got {lo}")
    dev = device if device is not None else next(
        w.device for w in words if isinstance(w, torch.Tensor))
    quads = torch.arange(lo // 4, lo // 4 + padded_quads(hi - lo),
                         dtype=torch.int64, device=dev)[None, :]
    x = philox4x32((quads,) + tuple(words), key)
    return box_muller(x)[:, :hi - lo]
