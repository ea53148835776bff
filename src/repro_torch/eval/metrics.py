"""Evaluation helpers (counterpart of ``repro/eval/metrics.py``)."""
from __future__ import annotations

import torch

from repro_torch.utils import tree_leaves


def classify_accuracy(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Share of rows whose argmax is the label, as a 0-d f32 tensor."""
    return (torch.argmax(logits, dim=-1) == labels).float().mean()


def evaluate_classifier(model, params, x: torch.Tensor, y: torch.Tensor,
                        batch: int = 512) -> float:
    """Batched global-test accuracy of an image classifier, each batch
    moved to the params' device and run without autograd."""
    device = tree_leaves(params)[0].device
    n = x.shape[0]
    correct = 0
    with torch.no_grad():
        for i in range(0, n, batch):
            logits = model.forward_train(
                params, {"images": x[i:i + batch].to(device)})
            correct += int((torch.argmax(logits, dim=-1)
                            == y[i:i + batch].to(device)).sum())
    return correct / n
