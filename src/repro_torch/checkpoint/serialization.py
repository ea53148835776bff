"""Tree <-> ``.npz`` serialization, path-keyed, with numpy alone
(counterpart of ``repro/checkpoint/serialization.py``).

A tree is nested NamedTuples, dicts (walked in sorted-key order) and
numpy leaves; ``None`` holds no leaf. A file stores leaf i as
``leaf_i`` and a ``__meta__`` JSON blob with each leaf's path string and
the leaf count. Path strings are the reference's (``_path_str`` over
``jax.tree_util`` paths): a NamedTuple field is ``.name``, a dict key is
the key, joined by ``/`` (``.global_params/conv0/b``,
``.scores/.tester_trust``), so a reference checkpoint reads by path
(:func:`read_leaves`). numpy has no bfloat16: a caller stores bf16
leaves as f32, which holds them exactly.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A template leaf: its shape (None: any) and numpy dtype."""

    shape: Optional[Tuple[int, ...]]
    dtype: Any


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path string, leaf)]`` in the reference's leaf order."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for part, node in items:
        out.extend(flatten_with_paths(node, f"{prefix}/{part}"
                                      if prefix else part))
    return out


def unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, dict):
        return {k: unflatten(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def conform(template: Any, got: List[Tuple[str, Any]]) -> Any:
    """The ``(path, leaf)`` list ``got`` in ``template``'s structure, each
    leaf checked against its template leaf's shape and cast to its dtype;
    ``ValueError`` on a leaf-count, path or shape mismatch."""
    want = flatten_with_paths(template)
    if len(got) != len(want):
        raise ValueError(f"state has {len(got)} leaves, template expects "
                         f"{len(want)} — wrong run or torn write")
    out = []
    for i, ((path, spec), (got_path, leaf)) in enumerate(zip(want, got)):
        arr = np.asarray(leaf)
        if got_path != path:
            raise ValueError(f"leaf_{i} is {got_path!r}, template expects "
                             f"{path!r}")
        if spec.shape is not None and tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"leaf_{i} ({path}) shape {arr.shape} != "
                             f"template {tuple(spec.shape)}")
        out.append(arr.astype(spec.dtype, copy=False))
    return unflatten(template, iter(out))


def save_pytree(tree: Any, path: Any) -> None:
    """Write ``tree`` (numpy leaves) to ``path``, a file name or an open
    binary file (the manager's atomic writer hands the latter)."""
    flat = flatten_with_paths(tree)
    arrays = {f"leaf_{i}": np.asarray(leaf)
              for i, (_, leaf) in enumerate(flat)}
    meta = json.dumps({"paths": [p for p, _ in flat],
                       "num_leaves": len(flat)})
    blob = np.frombuffer(meta.encode(), dtype=np.uint8)
    if hasattr(path, "write"):
        np.savez(path, __meta__=blob, **arrays)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, __meta__=blob, **arrays)


def read_leaves(path: str) -> Dict[str, np.ndarray]:
    """Every leaf of a checkpoint file, by path string (a file of either
    package)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        stored = sum(1 for k in z.files if k.startswith("leaf_"))
        if stored != meta["num_leaves"] or stored != len(meta["paths"]):
            raise ValueError(f"{path}: {stored} leaves stored, the meta "
                             f"names {meta['num_leaves']} — torn write")
        return {p: z[f"leaf_{i}"] for i, p in enumerate(meta["paths"])}


def params_tree(leaves: Dict[str, np.ndarray],
                prefix: str = ".global_params/") -> Dict[str, Any]:
    """The nested dict of the leaves under ``prefix`` (the round state's
    params, in a checkpoint of either package), from
    :func:`read_leaves`: ``.global_params/conv0/b`` becomes
    ``{"conv0": {"b": ...}}``."""
    params: Dict[str, Any] = {}
    for p, arr in leaves.items():
        if p.startswith(prefix):
            node = params
            *parents, name = p[len(prefix):].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[name] = arr
    return params


def load_pytree(template: Any, path: str) -> Any:
    """Restore ``path`` into ``template``'s structure (a tree of
    :class:`LeafSpec`), refusing a leaf count, path or shape that differs
    from the template's with ``ValueError``."""
    return conform(template, list(read_leaves(path).items()))
