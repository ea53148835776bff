"""Plain PyTorch version of the fused dequantise-aggregate:
``sum_c w_c * dequant(q_c)``, dequantised as ``Int8.decode`` does
(reshape to chunks, multiply by the chunk's scale), reduced in f32."""
from __future__ import annotations

import torch


def dequant_aggregate_ref(w: torch.Tensor, scales: torch.Tensor,
                          q: torch.Tensor, chunk: int) -> torch.Tensor:
    """w [C]; scales [C, M/chunk]; q [C, M] int8 -> [M] f32."""
    C, M = q.shape
    dec = (q.float().reshape(C, M // chunk, chunk)
           * scales.float()[:, :, None]).reshape(C, M)
    return w.float() @ dec
