"""The initial global model, made by the benchmark from the seed on the
device and handed to the program and to the reference alike: one normal
draw for every matrix, split and scaled by each leaf's spread (its
fan-in's inverse root, or 0.02 for an embedding), in the
type the model is served in; vectors are zeros (biases) or ones (norm
scales)."""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from fedbench.traffic import WEIGHTS, generator


def leaves(tree: Dict[str, Any], prefix: str = ""):
    """``(path, leaf)`` in sorted key order, recursively (the program's
    ``tree_leaves`` order, which its noise draws follow)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def tree_from(paths: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in paths.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def make_params(specs: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """``specs``: a tree of ``(shape, dtype, std, kind)`` leaves, kind
    ``"matrix"``, ``"zeros"`` or ``"ones"``. Matrices are N(0, 1) cut at
    +-3, times ``std``."""
    gen = generator(seed, WEIGHTS, device)
    flat = list(leaves(specs, ""))
    total = sum(math.prod(s[0]) for _, s in flat if s[3] == "matrix")
    z = torch.randn((total,), generator=gen, device=device).clamp_(-3, 3)
    out, at = {}, 0
    for path, (shape, dtype, std, kind) in flat:
        if kind == "matrix":
            n = math.prod(shape)
            out[path] = (z[at:at + n].reshape(shape) * std).to(dtype)
            at += n
        elif kind == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[path] = torch.ones(shape, dtype=dtype, device=device)
    return tree_from(out)
