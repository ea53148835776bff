"""Param trees: nested dicts of tensors, walked in sorted-key order.

The reference's pytrees are nested dicts, and ``jax.tree_util`` visits
dict keys in sorted order. Every port helper here walks the same order,
so "leaf i" means the same leaf in both packages — the order the
``random_weights`` noise draws and the per-leaf aggregation launches
follow.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Sequence

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


def tree_size(tree: Tree) -> int:
    """The number of elements over the leaves."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree: Tree) -> int:
    """The bytes the leaves hold."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, tree)


def tree_weighted_sum(trees, weights) -> Tree:
    """``sum_i w_i * tree_i``, accumulated in f32 and cast back to each
    leaf's dtype. ``trees`` is a list of trees, or one tree whose leaves
    are stacked on a leading client axis; ``weights`` has one entry a
    client."""
    weights = torch.as_tensor(weights)
    if isinstance(trees, (list, tuple)):
        stacked = tree_map(lambda *xs: torch.stack(xs), *trees)
    else:
        stacked = trees

    def comb(x):
        w = weights.to(x.device, torch.float32).reshape(
            (-1,) + (1,) * (x.dim() - 1))
        return (x.float() * w).sum(0).to(x.dtype)

    return tree_map(comb, stacked)


def tree_l2_norm(tree: Tree) -> torch.Tensor:
    """The f32 l2 norm of every leaf together."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def tree_cast(tree: Tree, dtype) -> Tree:
    """The floating leaves cast to ``dtype``; the others as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def flat_update_dim(model) -> int:
    """Width D of the flattened update vector: the params of ``model``,
    in the layout of ``_flatten_updates`` (``tree_leaves`` order, each
    leaf raveled)."""
    return sum(math.prod(shape) or 1
               for shape in tree_leaves(model.param_shapes()))


def tree_add_vector(tree: Tree, vec: torch.Tensor) -> Tree:
    """``tree + unflatten(vec)``: scatter a flat ``[D]`` update onto the
    leaves (``tree_leaves`` order, each leaf flattened — the layout of the
    round's ``[N, D]`` update matrix), add in f32 and cast back to each
    leaf's dtype. A ``[N, D]`` ``vec`` gives a tree stacked on a leading
    ``[N]`` axis, one row per client."""
    width = sum(leaf.numel() for leaf in tree_leaves(tree))
    if vec.shape[-1] != width:
        raise ValueError(f"vector width {vec.shape[-1]} != the tree's "
                         f"{width} params")
    off = 0

    def add(leaf):
        nonlocal off
        n = leaf.numel()
        part = vec[..., off:off + n].reshape(vec.shape[:-1] + leaf.shape)
        off += n
        return (leaf.float() + part).to(leaf.dtype)

    return tree_map(add, tree)


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


def pack_leaves(tensors: Sequence[torch.Tensor]):
    """The tensors as one flat buffer a dtype, in first-seen dtype order
    (what a collective sends in one call): ``(plan, flats)``, ``plan``
    the (dtype, member indices) of each buffer."""
    plan: List = []
    for i, t in enumerate(tensors):
        for dtype, members in plan:
            if dtype == t.dtype:
                members.append(i)
                break
        else:
            plan.append((t.dtype, [i]))
    flats = [torch.cat([tensors[i].reshape(-1) for i in members])
             for _, members in plan]
    return plan, flats


def unpack_leaves(plan, flats, shapes, lead=()) -> List[torch.Tensor]:
    """The tensors :func:`pack_leaves` packed (with ``lead`` axes in front)."""
    out: List = [None] * len(shapes)
    for (_, members), flat in zip(plan, flats):
        off = 0
        for i in members:
            n = math.prod(shapes[i])
            out[i] = flat[..., off:off + n].reshape(tuple(lead)
                                                    + tuple(shapes[i]))
            off += n
    return out


class PackedTree(NamedTuple):
    """A param tree as one flat buffer a dtype, the form a ring hop sends;
    :meth:`tree` gives views of the buffers in the tree's layout."""

    like: Any                  # a tree of the layout (leaf shapes)
    plan: List                 # pack_leaves' (dtype, member indices) a buffer
    flats: List[torch.Tensor]

    @classmethod
    def of(cls, tree) -> "PackedTree":
        return cls(tree, *pack_leaves(tree_leaves(tree)))

    def tree(self):
        shapes = [tuple(t.shape) for t in tree_leaves(self.like)]
        parts = iter(unpack_leaves(self.plan, self.flats, shapes))
        return tree_map(lambda _: next(parts), self.like)
