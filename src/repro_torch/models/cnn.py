"""The paper's own model (Sec. III): three conv layers + two dense layers.

Params keep the reference's layout: conv weights HWIO, dense weights
``[in, out]``, images NHWC. The forward does the layout changes: the
weights go to OIHW for ``F.conv2d``, the activations run NCHW through
the conv stack, and they return to NHWC before the flatten, because the
rows of ``fc1.w`` are in H·W·C order.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models.common import dense_init


class _Slot(nn.Module):
    """Names one layer's ``w`` and ``b`` for ``functional_call``; the
    placeholders live on the meta device and are never read."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.empty(0, device="meta"))
        self.b = nn.Parameter(torch.empty(0, device="meta"))


def pooled_size(cfg) -> int:
    """Spatial size after ``len(cnn_channels)`` 2x2 pools (odd sizes
    round up, as the reference's ``-inf`` padding does)."""
    s = cfg.image_size
    for _ in cfg.cnn_channels:
        s = (s + 1) // 2
    return s


def cnn_param_shapes(cfg) -> Dict:
    chans = (cfg.image_channels,) + tuple(cfg.cnn_channels)
    shapes: Dict = {}
    for i in range(len(cfg.cnn_channels)):
        shapes[f"conv{i}"] = {"w": (3, 3, chans[i], chans[i + 1]),
                              "b": (chans[i + 1],)}
    flat = pooled_size(cfg) ** 2 * cfg.cnn_channels[-1]
    shapes["fc1"] = {"w": (flat, cfg.cnn_hidden), "b": (cfg.cnn_hidden,)}
    shapes["fc2"] = {"w": (cfg.cnn_hidden, cfg.num_classes),
                     "b": (cfg.num_classes,)}
    return shapes


def init_cnn(cfg, gen: torch.Generator, dtype=torch.float32) -> Dict:
    p: Dict = {}
    for name, s in cnn_param_shapes(cfg).items():
        if name.startswith("conv"):
            w = dense_init(gen, (s["w"][0] * s["w"][1] * s["w"][2],)
                           + s["w"][3:]).reshape(s["w"])
        else:
            w = dense_init(gen, s["w"])
        p[name] = {"w": w.to(dtype),
                   "b": torch.zeros(s["b"], dtype=dtype, device=gen.device)}
    return p


class CNN(nn.Module):
    """images [B, H, W, C] -> logits [B, num_classes]."""

    def __init__(self, cfg):
        super().__init__()
        self.num_conv = len(cfg.cnn_channels)
        for i in range(self.num_conv):
            self.add_module(f"conv{i}", _Slot())
        self.fc1 = _Slot()
        self.fc2 = _Slot()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)                     # NHWC -> NCHW
        for i in range(self.num_conv):
            layer = getattr(self, f"conv{i}")
            # HWIO -> OIHW; "SAME" for a 3x3 kernel at stride 1 is pad 1
            x = F.conv2d(x, layer.w.permute(3, 2, 0, 1), layer.b, padding=1)
            # ceil_mode pads an odd edge with -inf, as _maxpool2 does
            x = F.max_pool2d(F.relu(x), 2, ceil_mode=True)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = F.relu(x @ self.fc1.w + self.fc1.b)
        return x @ self.fc2.w + self.fc2.b
