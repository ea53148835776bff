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
"""
from __future__ import annotations

from typing import List, Tuple

import torch

# Larger than any finite fp32 update coordinate, small enough that
# 0 * _MASKED_SENTINEL == 0 stays exact (never inf, so no 0*inf NaNs).
_MASKED_SENTINEL = 3.0e38


def oddeven_merge_pairs(c: int) -> List[Tuple[int, int]]:
    """Compare-exchange schedule of Batcher's odd-even mergesort for ``c``
    rows (the arbitrary-n iterative form, ``O(c log^2 c)`` comparators).
    ``csrc/robust_combine.cu`` builds the same list at compile time for
    c <= 64 and walks it at run time above (:func:`merge_pairs_by_loops`)."""
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


def merge_pairs_by_loops(c: int) -> List[Tuple[int, int]]:
    """The schedule as ``csrc/robust_combine.cu``'s shared-memory kernel
    (C > 64) generates it at run time: the loops of
    :func:`oddeven_merge_pairs` with ``// (2 p)`` taken as a right shift
    by ``ffs(p)``, so that the two can be held equal."""
    pairs = []
    p = 1
    while p < c:
        shift = (p & -p).bit_length()      # CUDA's __ffs(p)
        k = p
        while k >= 1:
            for j in range(k % p, c - k, 2 * k):
                for i in range(min(k, c - j - k)):
                    lo, hi = i + j, i + j + k
                    if lo >> shift == hi >> shift:
                        pairs.append((lo, hi))
            k //= 2
        p *= 2
    return pairs


def sort_rows(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sort a list of equal-shape tensors elementwise with the network.
    ``torch.minimum`` / ``torch.maximum`` propagate NaN."""
    rows = list(rows)
    for i, j in oddeven_merge_pairs(len(rows)):
        a, b = rows[i], rows[j]
        rows[i] = torch.minimum(a, b)
        rows[j] = torch.maximum(a, b)
    return rows


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.float()[:, None] > 0.0, x.float(),
                       _MASKED_SENTINEL)


def robust_combine_network_ref(x: torch.Tensor, mask: torch.Tensor,
                               w_row: torch.Tensor) -> torch.Tensor:
    """x [C, M]; mask [C]; w_row [C] (sorted-position weights) -> [M]."""
    rows = sort_rows(list(_masked(x, mask)))
    w = w_row.float()
    acc = rows[0] * w[0]
    for i in range(1, len(rows)):
        acc = acc + rows[i] * w[i]
    return acc.to(x.dtype)


def robust_combine_ref(x: torch.Tensor, mask: torch.Tensor,
                       w_row: torch.Tensor) -> torch.Tensor:
    """The ``torch.sort`` oracle: x [C, M]; mask [C]; w_row [C] -> [M]."""
    xs = torch.sort(_masked(x, mask), dim=0).values
    return torch.einsum("c,cm->m", w_row.float(), xs).to(x.dtype)
