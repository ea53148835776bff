"""Family-independent model facade (the cnn/mlp side of
``repro/models/model.py``).

    m = build_model(cfg)
    params = m.init(gen)                       # on gen's device
    logits = m.forward_train(params, {"images": x})
    loss, metrics = m.loss(params, {"images": x, "labels": y})

Batches are ``{"images": [B,H,W,C], "labels": [B]}``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.func import functional_call

from repro_torch.config import ModelConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import softmax_cross_entropy, token_accuracy
from repro_torch.utils import flat_names, tree_leaves

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # the family's weightless module, driven through functional_call
    net: torch.nn.Module = dataclasses.field(init=False, repr=False,
                                             compare=False)

    def __post_init__(self):
        object.__setattr__(self, "net", cnn_mod.CNN(self.cfg)
                           if self.cfg.family == "cnn"
                           else mlp_mod.MLP(self.cfg))

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    def param_shapes(self) -> Dict[str, Any]:
        """Nested dict of leaf shapes, in the reference's tree."""
        if self.cfg.family == "cnn":
            return cnn_mod.cnn_param_shapes(self.cfg)
        return mlp_mod.mlp_param_shapes(self.cfg)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Fresh params, drawn from ``gen`` on its device."""
        if self.cfg.family == "cnn":
            return cnn_mod.init_cnn(self.cfg, gen, self.dtype)
        return mlp_mod.init_mlp(self.cfg, gen, self.dtype)

    def forward_train(self, params, batch) -> torch.Tensor:
        """Logits ``[B, num_classes]``."""
        return functional_call(self.net, flat_names(params),
                               (batch["images"],))

    def loss(self, params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = self.forward_train(params, batch)
        nll = softmax_cross_entropy(logits, batch["labels"])
        acc = token_accuracy(logits, batch["labels"])
        return nll, {"nll": nll, "accuracy": acc}

    def param_count(self, params=None) -> int:
        if params is None:
            return sum(math.prod(s) for s in tree_leaves(self.param_shapes()))
        return sum(x.numel() for x in tree_leaves(params))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
