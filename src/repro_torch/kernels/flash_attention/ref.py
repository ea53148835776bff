"""Plain PyTorch version of flash attention: the naive materialised
softmax of ``repro/kernels/flash_attention/ref.py`` (``attention_ref``).

Layout: q [B, S, Hq, D]; k, v [B, T, Hkv, D]; output [B, S, Hq, D].
GQA: Hq is a multiple of Hkv, and query head h reads KV head h // (Hq/Hkv).
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sliding_window: Optional[int] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Naive attention in f32, cast back to q's dtype. ``q_offset``
    places the queries inside a longer KV: query i attends key t iff
    t <= i + q_offset (causal) and t > i + q_offset - sliding_window.
    A query with no key to attend gives 0."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    rep = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kr = k.float().repeat_interleave(rep, dim=2)
    vr = v.float().repeat_interleave(rep, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), kr) * scale
    qpos = torch.arange(S, device=q.device)[:, None] + q_offset
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.nan_to_num(torch.exp(
        logits - logits.amax(dim=-1, keepdim=True)))
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bhst,bthd->bshd", probs, vr).to(q.dtype)
