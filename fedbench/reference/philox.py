"""Counter-based draws in plain PyTorch: Philox-4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011), uniforms from a
word's top 23 bits, Box-Muller normals, and the 63-bit seeds numpy's
``SeedSequence`` derives from a tuple of integers. These are the
published algorithms, written out here so that the reference draws the
keyed streams of the population tier (its shards and its attack noise)
without the program."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MULTIPLIERS = (0xD2511F53, 0xCD9E8D57)
WEYL = (0x9E3779B9, 0xBB67AE85)


def derived_seed(*parts: int) -> int:
    """``SeedSequence(parts)``'s first two 32-bit words, the high one cut
    to 31 bits: a 63-bit seed."""
    lo, hi = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return int(lo) | (int(hi) & 0x7FFFFFFF) << 32


def key_of(*parts: int) -> Tuple[int, int]:
    seed = derived_seed(*parts)
    return seed & MASK32, seed >> 32


def _mul(a: torch.Tensor, m: int):
    """High and low words of the 64-bit product of the 32-bit ``a``
    (int64) and ``m``, through ``m``'s 16-bit halves (no partial product
    reaches 2**63)."""
    lo_part = a * (m & 0xFFFF)
    hi_part = a * (m >> 16)
    low = (lo_part + ((hi_part & 0xFFFF) << 16)) & MASK32
    high = (hi_part + (lo_part >> 16)) >> 16
    return high, low


def philox(counter: Sequence, key: Tuple[int, int], rounds: int = 10):
    """The four output words of each counter (four int64 tensors or ints
    in [0, 2**32), broadcast together) under ``key``."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      if not isinstance(c, torch.Tensor) else c
                      for c in counter)
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + WEYL[0]) & MASK32, (k1 + WEYL[1]) & MASK32
        h0, l0 = _mul(c0, MULTIPLIERS[0])
        h1, l1 = _mul(c2, MULTIPLIERS[1])
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def uniform(word: torch.Tensor) -> torch.Tensor:
    """A word's top 23 bits as an odd multiple of 2**-24 in (0, 1)."""
    return ((word >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24


def normals(words) -> torch.Tensor:
    """Box-Muller on words 0, 1 and on 2, 3 of each counter: ``[...,
    4]`` normals a counter, lane order (r0 cos, r0 sin, r1 cos, r1
    sin)."""
    out = []
    for a, b in ((words[0], words[1]), (words[2], words[3])):
        r = torch.sqrt(-2.0 * torch.log(uniform(a)))
        t = (2.0 * math.pi) * uniform(b)
        out += [r * torch.cos(t), r * torch.sin(t)]
    return torch.stack(out, -1)


def stream_normals(key, words: Sequence, count: int, device
                   ) -> torch.Tensor:
    """``count`` normals of the stream named by three counter words
    (each an int or a ``[rows, 1]`` int64 tensor): element i is lane
    i % 4 of counter (i // 4, *words). ``[rows, count]``."""
    quads = torch.arange(-(-count // 4), dtype=torch.int64,
                         device=device)[None, :]
    z = normals(philox((quads,) + tuple(words), key))
    return z.reshape(z.shape[0], -1)[:, :count]
