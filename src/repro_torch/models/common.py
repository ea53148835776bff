"""Shared pieces of the classifiers: initializer, loss and accuracy."""
from __future__ import annotations

import torch


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    ``fan_in ** -0.5``, drawn on ``gen``'s device."""
    fan_in = shape[in_axis]
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * fan_in ** -0.5).to(dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -1) -> torch.Tensor:
    """Mean NLL over non-ignored labels, in fp32. logits [..., V]."""
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -1) -> torch.Tensor:
    labels = labels.long()
    valid = labels != ignore_index
    correct = (torch.argmax(logits, dim=-1) == labels) & valid
    return correct.sum() / valid.sum().clamp(min=1)
