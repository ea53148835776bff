"""State converter: the reference's params and error-feedback buffer ->
the port's.

Both packages keep the same tree (names, layouts, dtypes: conv weights
HWIO, dense weights ``[in, out]``, decoder layers stacked ``[L, ...]``),
so conversion is a checked, name-for-name copy of the leaves onto a
device, and the flat ``[N, D]`` update layout is the same in both.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.utils import flat_update_dim


def params_from_reference(tree_of_numpy: Dict[str, Any], device, *,
                          model) -> Dict[str, Any]:
    """Nested dict of numpy arrays (the JAX package's params) -> nested
    dict of tensors on ``device``, each leaf in its dtype in
    ``model.param_dtypes()``: the model's dtype, and f32 for the LMs'
    RMSNorm scales and the mamba block's ``dt_bias``, ``A_log`` and ``D``,
    which the reference keeps in f32 in a bf16 model.
    Refuses a missing or extra leaf and a shape mismatch against
    ``model.param_shapes()``. A bf16 leaf arrives as an ``ml_dtypes``
    bfloat16 array and goes through f32, which holds it exactly."""
    def convert(node, shapes, dtypes, path):
        if isinstance(shapes, dict):
            if not isinstance(node, dict):
                raise ValueError(f"{path or 'params'}: expected a dict of "
                                 f"{sorted(shapes)}, got {type(node).__name__}")
            missing = sorted(set(shapes) - set(node))
            extra = sorted(set(node) - set(shapes))
            if missing or extra:
                raise ValueError(f"{path or 'params'}: missing leaves "
                                 f"{missing}, unexpected leaves {extra}")
            return {k: convert(node[k], shapes[k], dtypes[k],
                               f"{path}.{k}".lstrip("."))
                    for k in sorted(shapes)}
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(shapes):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != expected "
                             f"{tuple(shapes)}")
        return torch.as_tensor(arr.astype(np.float32), device=device
                               ).to(dtypes)

    return convert(tree_of_numpy, model.param_shapes(), model.param_dtypes(),
                   "")


def comp_state_from_reference(comp_state, device, *, model,
                              num_users: int) -> torch.Tensor:
    """The reference's ``[N, D]`` error-feedback buffer (numpy) -> an f32
    tensor on ``device``. Refuses a shape other than ``[num_users,
    flat_update_dim(model)]`` and a non-finite entry."""
    arr = np.asarray(comp_state)
    want = (num_users, flat_update_dim(model))
    if tuple(arr.shape) != want:
        raise ValueError(f"comp_state shape {tuple(arr.shape)} != expected "
                         f"{want} (num_users, flat update width)")
    if not np.isfinite(arr).all():
        raise ValueError("comp_state holds non-finite entries")
    return torch.as_tensor(arr.astype(np.float32), device=device)
