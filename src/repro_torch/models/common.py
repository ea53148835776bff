"""Shared building blocks: initializers, RMSNorm and LayerNorm, rotary
and sinusoidal positions, loss and accuracy (the port's side of
``repro/models/common.py``)."""
from __future__ import annotations

import torch

from repro_torch.sharding import arange_like, is_sharded


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    ``fan_in ** -0.5``, drawn on ``gen``'s device."""
    fan_in = shape[in_axis]
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * fan_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32
               ) -> torch.Tensor:
    """N(0, 0.02^2) embedding table, drawn in f32 on ``gen``'s device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    t.normal_(0.0, 1.0, generator=gen)
    return (t * 0.02).to(dtype)


def rms_norm_init(dim: int, device=None):
    """The RMSNorm scale, kept in f32 whatever the model's dtype, as the
    reference keeps it."""
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32 against the f32
    ``scale``, then cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def layer_norm_init(dim: int, device=None):
    """LayerNorm scale (one) and bias (zero), kept in f32 whatever the
    model's dtype, as the reference keeps them."""
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32 with the biased variance (the
    reference's ``jnp.var``), against the f32 scale and bias, then cast
    back to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, the half-split form (the first and second halves
    of the head dim rotate as pairs), computed in f32 and cast back.
    x [..., S, H, D]; positions [..., S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs        # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table ``[seq, dim]`` in f32: the sines of
    ``half = dim // 2`` timescales, then their cosines (``[sin | cos]``,
    not interleaved), timescale j at ``exp(-j log(10000) / max(half - 1,
    1))``, the log taken in f32 as the reference takes it. Made on
    ``device`` alone (no host copy), so a CUDA graph may capture it."""
    half = dim // 2
    log_timescale = torch.full((), 10_000.0, dtype=torch.float32,
                               device=device).log() / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=device))
    scaled = (torch.arange(seq, dtype=torch.float32, device=device)[:, None]
              * inv[None, :])
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def gold_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``: a gather, or on a DTensor under the
    dry-run's rules (which cannot gather along a vocab sharded over the
    mesh) the masked sum over the vocab."""
    if is_sharded(logits):
        hit = labels[..., None] == arange_like(logits)
        return torch.where(hit, logits, 0.0).sum(-1)
    return torch.gather(logits, -1, labels[..., None])[..., 0]


def argmax_vocab(logits: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last dimension; on a DTensor under the dry-run's
    rules (no argmax along a sharded vocab) the least index holding the
    maximum, which is what ``argmax`` returns."""
    if is_sharded(logits):
        top = logits.amax(dim=-1, keepdim=True)
        return torch.where(logits == top, arange_like(logits),
                           logits.shape[-1]).amin(dim=-1)
    return torch.argmax(logits, dim=-1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -1) -> torch.Tensor:
    """Mean NLL over non-ignored labels, in fp32. logits [..., V]."""
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = gold_logits(lf, safe)
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -1) -> torch.Tensor:
    labels = labels.long()
    valid = labels != ignore_index
    correct = (argmax_vocab(logits) == labels) & valid
    return correct.sum() / valid.sum().clamp(min=1)
