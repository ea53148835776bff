"""The paper's CNN in plain PyTorch: parameters in the reference
package's layout (conv weights HWIO, dense weights ``[in, out]``, images
NHWC), 3x3 same convolutions, ReLU, 2x2 max pools (an odd edge rounds
up), then two dense layers."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def param_specs(cfg: dict):
    """``{layer: {"w": (shape, dtype, std, kind), "b": ...}}``."""
    chans = [cfg["image_channels"]] + list(cfg["cnn_channels"])
    specs = {}
    size = cfg["image_size"]
    for i, (cin, cout) in enumerate(zip(chans, chans[1:])):
        specs[f"conv{i}"] = {"w": ((3, 3, cin, cout), torch.float32,
                                   (9 * cin) ** -0.5, "matrix"),
                             "b": ((cout,), torch.float32, 0, "zeros")}
        size = (size + 1) // 2
    flat, hid = size * size * chans[-1], cfg["cnn_hidden"]
    specs["fc1"] = {"w": ((flat, hid), torch.float32, flat ** -0.5, "matrix"),
                    "b": ((hid,), torch.float32, 0, "zeros")}
    specs["fc2"] = {"w": ((hid, cfg["num_classes"]), torch.float32,
                          hid ** -0.5, "matrix"),
                    "b": ((cfg["num_classes"],), torch.float32, 0, "zeros")}
    return specs


class CNN:
    """``forward(params, images [B, H, W, C]) -> logits [B, classes]``."""

    def __init__(self, cfg: dict):
        self.convs = len(cfg["cnn_channels"])

    def forward(self, p, images):
        x = images.permute(0, 3, 1, 2)
        for i in range(self.convs):
            layer = p[f"conv{i}"]
            x = F.conv2d(x, layer["w"].permute(3, 2, 0, 1), layer["b"],
                         padding=1)
            x = F.max_pool2d(F.relu(x), 2, ceil_mode=True)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
        return x @ p["fc2"]["w"] + p["fc2"]["b"]

    def eval_logits(self, p, x):
        return self.forward(p, x)

    def store(self, t):
        """How a parameter is kept between steps: float32."""
        return t

    def loss(self, p, x, y):
        return F.cross_entropy(self.forward(p, x), y.long())

    def accuracy(self, p, x, y):
        """Share of rows whose first maximal logit is the label."""
        return (self.forward(p, x).argmax(-1) == y.long()).float().mean()


def model(cfg: dict, precision: str = "float32") -> CNN:
    """The reference model; a CNN's precision is set around it
    (``fedtest.precision``)."""
    return CNN(cfg)
