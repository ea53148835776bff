"""Plain PyTorch version of the server aggregation: out = sum_c w_c * x_c."""
from __future__ import annotations

import torch


def weighted_aggregate_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [C, M]; w [C] -> [M], fp32 accumulation, cast back to x.dtype."""
    return (w.float() @ x.float()).to(x.dtype)
