"""Concrete sharding rule sets: logical activation axes + per-param specs
(the port's side of ``repro/sharding/rules.py``).

Activation rules (read by ``shard_hint`` inside model code) and parameter
specs (the placements the dry-run gives the params) both derive from the
mesh axis names, so the same model code serves:

* one pod   — mesh ("data", "model") = (32, 8), 256 H100s
* two pods  — mesh ("pod", "data", "model") = (2, 32, 8), 512 H100s

(``launch/mesh.py``). Parameter layout is FSDP-style: the "feature-out"
dimension of each matmul weight is sharded over ``model`` and the other
large dimension over (``pod``, ``data``); DTensor inserts the per-layer
all-gathers. Vectors and norm scales are replicated. A spec is a tuple
with one entry a tensor dimension (``None``, a mesh-axis name or a tuple
of them); :func:`to_placements` turns it into DTensor placements.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.utils import tree_map


def make_ruleset(axes: Tuple[str, ...], *, kind: str = "train",
                 batch_divisible: bool = True) -> Dict[str, object]:
    """Logical-axis -> mesh-axis rules for activations."""
    fsdp = tuple(a for a in axes if a != "model")
    fsdp = fsdp[0] if len(fsdp) == 1 else fsdp
    batch = fsdp if batch_divisible else None
    rules: Dict[str, object] = {
        "batch": batch,
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": None,
        "kv_seq": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_group": batch,
    }
    if kind == "decode" and not batch_divisible:
        # long-context decode with batch=1: spread the KV over everything
        rules["kv_seq"] = tuple(a for a in axes)
    return rules


RULESETS = {"make": make_ruleset}


# --------------------------------------------------------------- param specs
_MATMUL_SPECS = {
    # name -> (spec by dim, from the *trailing* dims of the leaf)
    "wq": ("fsdp", "model"),
    "wk": ("fsdp", "model"),
    "wv": ("fsdp", "model"),
    "wo": ("model", "fsdp"),
    "w_gate": ("fsdp", "model"),
    "w_up": ("fsdp", "model"),
    "w_down": ("model", "fsdp"),
    "w_in": ("fsdp", "model"),
    "w_out": ("model", "fsdp"),
    "in_proj": ("fsdp", "model"),
    "out_proj": ("model", "fsdp"),
    "router": ("fsdp", None),
    "embed": ("model", "fsdp"),      # vocab over model
    "lm_head": ("fsdp", "model"),
    "dec_pos": (None, "fsdp"),
    "patch_proj": ("fsdp", None),
    "conv_w": (None, "model"),
}
_MOE_SPECS = {  # leading expert dim over model (expert parallelism)
    "w_gate": ("model", "fsdp", None),
    "w_up": ("model", "fsdp", None),
    "w_down": ("model", None, "fsdp"),
}


def _resolve(axis_tag: Optional[str], fsdp_axes):
    if axis_tag == "fsdp":
        return fsdp_axes
    return axis_tag


def _leaf_spec(names, ndim: int, fsdp_axes) -> tuple:
    leafname = names[-1] if names else ""
    in_moe = "moe" in names
    stacked = sum(1 for n in names
                  if n in ("layers", "encoder", "decoder")
                  or n.startswith("slot_"))
    # slot_k lives under layers -> exactly one leading stack axis
    n_stack = 1 if stacked else 0

    table = _MOE_SPECS if (in_moe and leafname in _MOE_SPECS) else _MATMUL_SPECS
    if leafname in table:
        tags = table[leafname]
        spec = [_resolve(t, fsdp_axes) for t in tags]
        if n_stack and ndim == len(tags) + 1:
            spec = [None] + spec
        elif ndim != len(spec):
            spec = [None] * (ndim - len(spec)) + spec
        return tuple(spec)
    # vectors / norms / biases / scalar banks: replicate
    return (None,) * ndim


def _with_paths(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _with_paths(tree[k], fn, path + (k,)) for k in sorted(tree)}
    return fn(path, tree)


def param_spec_tree(params, axes: Tuple[str, ...]):
    """Spec tree matching ``params`` (a tree of tensors, fake or real)."""
    fsdp = tuple(a for a in axes if a != "model")
    fsdp = fsdp[0] if len(fsdp) == 1 else (fsdp if fsdp else None)
    return _with_paths(params, lambda path, leaf: _leaf_spec(
        list(path), leaf.ndim, fsdp))


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh axis: size} of a ``DeviceMesh`` or of a mapping of them."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def guard_spec(spec: tuple, shape, mesh) -> tuple:
    """``spec`` with each mesh axis entry that does not divide its
    dimension of ``shape`` dropped."""
    sizes = axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    fixed = []
    for dim, ax in zip(shape, entries):
        if ax is None:
            fixed.append(None)
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        size = math.prod(sizes[a] for a in axs)
        fixed.append(ax if dim % size == 0 else None)
    return tuple(fixed)


def guard_divisibility(spec_tree, shape_tree, mesh):
    """Drop mesh axes from specs whenever they don't divide the dim."""
    return tree_map(lambda spec, leaf: guard_spec(spec, leaf.shape, mesh),
                    spec_tree, shape_tree)


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements, one a mesh dimension, of a spec: ``Shard(d)``
    on each mesh axis that tensor dimension d names, ``Replicate()`` on
    the others and on an axis of size 1 (where the two are one layout). A
    mesh axis named twice raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is None or mesh.size(names.index(ax)) == 1:
                continue
            i = names.index(ax)
            if placements[i] != Replicate():
                raise ValueError(f"mesh axis {ax!r} shards two dimensions "
                                 f"in {spec}")
            placements[i] = Shard(dim)
    return tuple(placements)
