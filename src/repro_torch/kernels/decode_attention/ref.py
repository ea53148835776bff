"""Plain PyTorch version of single-token decode attention
(``repro/kernels/decode_attention/ref.py``, ``decode_attention_ref``).

q [B, Hq, D] attends a KV cache k/v [B, T, Hkv, D] of which the first
``lengths[b]`` entries are valid (the last ``window`` of them, with a
window). Returns (out [B, Hq, D], lse [B, Hq]); the log-sum-exp makes the
op composable across KV shards (``merge_partials``).
"""
from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *,
                         scale: Optional[float] = None,
                         window: Optional[int] = None):
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    rep = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kr = k.float().repeat_interleave(rep, dim=2)
    vr = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kr) * scale
    t = torch.arange(T, device=q.device)[None, :]
    lengths = lengths.to(q.device).long()[:, None]
    valid = t < lengths
    if window is not None:
        valid &= t >= lengths - window
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bht,bthd->bhd", p / l.clamp(min=1e-30), vr)
    lse = (m + torch.log(l.clamp(min=1e-30)))[..., 0]
    return out.to(q.dtype), lse
