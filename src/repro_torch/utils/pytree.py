"""Param trees: nested dicts of tensors, walked in sorted-key order.

The reference's pytrees are nested dicts, and ``jax.tree_util`` visits
dict keys in sorted order. Every port helper here walks the same order,
so "leaf i" means the same leaf in both packages — the order the
``random_weights`` noise draws and the per-leaf aggregation launches
follow.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(
                    f"tree structure mismatch: {sorted(tree)} vs "
                    f"{sorted(r) if isinstance(r, dict) else type(r)}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        out: List[Any] = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def flat_names(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"conv0": {"w": t}}`` -> ``{"conv0.w": t}`` (the naming
    ``torch.func.functional_call`` expects)."""
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_names(v, name + "."))
        else:
            out[name] = v
    return out
