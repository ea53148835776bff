"""Plain PyTorch versions of the per-coordinate robust combine.

Both reduce a ``[C, M]`` stack of client updates to ``[M]``: masked
clients are pushed past every finite value, each coordinate's C values
are sorted ascending, and the sorted stack is dotted with the caller's
sorted-position weights ``w_row`` (``ops.row_select_weights``).

* :func:`robust_combine_network_ref` sorts with the Batcher odd-even
  merge network of ``oddeven_merge_pairs`` as ``torch.minimum`` /
  ``torch.maximum`` row ops, the schedule the CUDA kernels walk. It is
  the CPU route of ``robust_combine``.
* :func:`robust_combine_ref` sorts with ``torch.sort``, the oracle the
  tests hold the network to.

The rest mirrors how ``csrc/robust_combine.cu`` walks the network above
64 clients, so that the CPU tests can hold each schedule to the plain
one: :func:`robust_combine_padded_ref` (65..128 clients, the network of
a padded size over +inf rows) and :func:`stage_pairs` /
:func:`sort_rows_staged` (above 128, 64-row segments in registers, then
the stages p >= 64 dealt out slot by slot).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

# Larger than any finite fp32 update coordinate, small enough that
# 0 * _MASKED_SENTINEL == 0 stays exact (never inf, so no 0*inf NaNs).
_MASKED_SENTINEL = 3.0e38
# the register tier's padded network sizes (csrc/robust_combine.cu: kPads)
# and the rows a warp of the shared-memory tier sorts in registers (kSeg)
REGISTER_PADS = (80, 96, 112, 128)
SEGMENT = 64


def oddeven_merge_pairs(c: int) -> List[Tuple[int, int]]:
    """Compare-exchange schedule of Batcher's odd-even mergesort for ``c``
    rows (the arbitrary-n iterative form, ``O(c log^2 c)`` comparators).
    ``csrc/robust_combine.cu`` builds the same list at compile time up to
    128 rows and deals it out stage by stage above
    (:func:`merge_pairs_by_loops`)."""
    pairs = []
    p = 1
    while p < c:
        k = p
        while k >= 1:
            for j in range(k % p, c - k, 2 * k):
                for i in range(min(k, c - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def merge_stages(c: int) -> List[Tuple[int, int]]:
    """The network's stages (p, k) in order: p = 1, 2, 4, ... below c,
    and for each k = p, p/2, ..., 1. A stage's pairs are disjoint."""
    stages = []
    p = 1
    while p < c:
        k = p
        while k >= 1:
            stages.append((p, k))
            k //= 2
        p *= 2
    return stages


def stage_slots(c: int, p: int, k: int) -> int:
    """How many slots the shared-memory kernel deals out for stage
    (p, k): k for each j in ``range(k % p, c - k, 2 k)``."""
    j0 = k % p
    return -(-(c - k - j0) // (2 * k)) * k if c - k > j0 else 0


def stage_pairs(c: int, p: int, k: int) -> List[Tuple[int, int]]:
    """Stage (p, k)'s pairs as the shared-memory kernel maps its slots to
    them: slot t is lo = k % p + 2 k (t // k) + t % k, hi = lo + k, kept
    where hi < c and both lie in one block of 2p rows (the kernel takes
    the divisions as shifts by log2 k and log2 2p, p and k powers of 2)."""
    pairs = []
    for t in range(stage_slots(c, p, k)):
        lo = k % p + 2 * k * (t // k) + t % k
        hi = lo + k
        if hi < c and lo // (2 * p) == hi // (2 * p):
            pairs.append((lo, hi))
    return pairs


def merge_pairs_by_loops(c: int) -> List[Tuple[int, int]]:
    """The schedule as ``csrc/robust_combine.cu``'s shared-memory kernel
    enumerates it: every stage's slots through :func:`stage_pairs`, in
    stage order, so that the two can be held equal."""
    return [pair for p, k in merge_stages(c) for pair in stage_pairs(c, p, k)]


def _compare_exchange(rows: List[torch.Tensor],
                      pairs: List[Tuple[int, int]]) -> List[torch.Tensor]:
    """The pairs' compare-exchanges over a copy of ``rows``, in order.
    ``torch.minimum`` / ``torch.maximum`` propagate NaN."""
    rows = list(rows)
    for i, j in pairs:
        a, b = rows[i], rows[j]
        rows[i] = torch.minimum(a, b)
        rows[j] = torch.maximum(a, b)
    return rows


def sort_rows(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sort a list of equal-shape tensors elementwise with the network."""
    return _compare_exchange(rows, oddeven_merge_pairs(len(rows)))


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.float()[:, None] > 0.0, x.float(),
                       _MASKED_SENTINEL)


def _dot(rows: List[torch.Tensor], w_row: torch.Tensor) -> torch.Tensor:
    """The sorted rows against their weights, in position order."""
    w = w_row.float()
    acc = rows[0] * w[0]
    for i in range(1, len(w)):
        acc = acc + rows[i] * w[i]
    return acc


def robust_combine_network_ref(x: torch.Tensor, mask: torch.Tensor,
                               w_row: torch.Tensor) -> torch.Tensor:
    """x [C, M]; mask [C]; w_row [C] (sorted-position weights) -> [M]."""
    return _dot(sort_rows(list(_masked(x, mask))), w_row).to(x.dtype)


def padded_rows(c: int) -> int:
    """The padded network size the register tier runs for 65..128 rows."""
    return next(cp for cp in REGISTER_PADS if c <= cp)


def robust_combine_padded_ref(x: torch.Tensor, mask: torch.Tensor,
                              w_row: torch.Tensor) -> torch.Tensor:
    """The register tier for 65..128 clients: the C masked rows padded
    with +inf rows to :func:`padded_rows`, sorted by that size's network,
    and the first C dotted with ``w_row``."""
    rows = list(_masked(x, mask))
    pad = torch.full_like(rows[0], float("inf"))
    rows = sort_rows(rows + [pad] * (padded_rows(len(rows)) - len(rows)))
    return _dot(rows, w_row).to(x.dtype)


def sort_rows_staged(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """The shared-memory tier's sort: each SEGMENT-row segment by the
    SEGMENT-row network (the short last one padded with +inf), which runs
    the stages p < SEGMENT, then the stages p >= SEGMENT a stage at a time
    through :func:`stage_pairs`."""
    c = len(rows)
    out = []
    for s in range(0, c, SEGMENT):
        seg = list(rows[s:s + SEGMENT])
        pad = torch.full_like(seg[0], float("inf"))
        out += sort_rows(seg + [pad] * (SEGMENT - len(seg)))[:len(seg)]
    return _compare_exchange(out, [pair for p, k in merge_stages(c)
                                   if p >= SEGMENT
                                   for pair in stage_pairs(c, p, k)])


def robust_combine_ref(x: torch.Tensor, mask: torch.Tensor,
                       w_row: torch.Tensor) -> torch.Tensor:
    """The ``torch.sort`` oracle: x [C, M]; mask [C]; w_row [C] -> [M]."""
    xs = torch.sort(_masked(x, mask), dim=0).values
    return torch.einsum("c,cm->m", w_row.float(), xs).to(x.dtype)
