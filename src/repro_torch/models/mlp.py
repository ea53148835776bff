"""Feed-forward blocks: the SwiGLU FFN of the decoder LMs, whisper's GELU
MLP, and the paper's MNIST fully-connected classifier (family ``mlp``)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models.cnn import _Slot
from repro_torch.models.common import dense_init
from repro_torch.sharding import shard_hint


def swiglu_shapes(d_model: int, d_ff: int) -> Dict:
    return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
            "w_down": (d_ff, d_model)}


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                lead=()) -> Dict:
    """Fan-in truncated-normal weights; ``lead`` prepends stacked axes."""
    return {name: dense_init(gen, lead + shape, in_axis=len(lead),
                             dtype=dtype)
            for name, shape in swiglu_shapes(d_model, d_ff).items()}


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """SiLU of the gate in f32, cast back, times the up projection, then
    the down projection."""
    h = F.silu((x @ p["w_gate"]).float()).to(x.dtype)
    h = shard_hint(h * (x @ p["w_up"]), ("batch", "seq", "mlp"))
    return shard_hint(h @ p["w_down"], ("batch", "seq", "embed"))


def gelu_mlp_specs(d_model: int, d_ff: int, dtype) -> Dict:
    """Leaf shapes and dtypes: ``{name: (shape, dtype)}``, biases in the
    model's dtype as the reference keeps them."""
    return {"w_in": ((d_model, d_ff), dtype), "b_in": ((d_ff,), dtype),
            "w_out": ((d_ff, d_model), dtype), "b_out": ((d_model,), dtype)}


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                  lead=()) -> Dict:
    """Fan-in truncated-normal weights, zero biases; ``lead`` prepends
    stacked axes."""
    out = {}
    for name, (shape, dt) in gelu_mlp_specs(d_model, d_ff, dtype).items():
        out[name] = (dense_init(gen, lead + shape, in_axis=len(lead),
                                dtype=dt) if name.startswith("w") else
                     torch.zeros(lead + shape, dtype=dt, device=gen.device))
    return out


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """GELU of the input projection in f32, cast back, then the output
    projection. The GELU is the tanh approximation, ``jax.nn.gelu``'s
    default (torch's own default is the erf form)."""
    h = F.gelu((x @ p["w_in"] + p["b_in"]).float(), approximate="tanh")
    h = shard_hint(h.to(x.dtype), ("batch", "seq", "mlp"))
    return shard_hint(h @ p["w_out"] + p["b_out"], ("batch", "seq", "embed"))


def mlp_param_shapes(cfg) -> Dict:
    dims = ((cfg.image_size * cfg.image_size * max(cfg.image_channels, 1),)
            + tuple(cfg.mlp_hidden) + (cfg.num_classes,))
    return {f"fc{i}": {"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
            for i in range(len(dims) - 1)}


def init_mlp(cfg, gen: torch.Generator, dtype=torch.float32) -> Dict:
    return {name: {"w": dense_init(gen, s["w"], dtype=dtype),
                   "b": torch.zeros(s["b"], dtype=dtype, device=gen.device)}
            for name, s in mlp_param_shapes(cfg).items()}


class MLP(nn.Module):
    """images [B, H, W, C] (or [B, D]) -> logits [B, num_classes]."""

    def __init__(self, cfg):
        super().__init__()
        self.num_hidden = len(cfg.mlp_hidden)
        for i in range(self.num_hidden + 1):
            self.add_module(f"fc{i}", _Slot())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.reshape(images.shape[0], -1)
        for i in range(self.num_hidden):
            layer = getattr(self, f"fc{i}")
            x = F.relu(x @ layer.w + layer.b)
        last = getattr(self, f"fc{self.num_hidden}")
        return x @ last.w + last.b
