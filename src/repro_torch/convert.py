"""State converter: the reference's params, error-feedback buffer and
checkpoints -> the port's.

Both packages keep the same tree (names, layouts, dtypes: conv weights
HWIO, dense weights ``[in, out]``, LM layers stacked ``[L, ...]``),
so conversion is a checked, name-for-name copy of the leaves onto a
device, and the flat ``[N, D]`` update layout is the same in both.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint import (
    manifest_mismatches, params_tree, read_leaves)
from repro_torch.checkpoint.manager import MANIFEST_NAME
from repro_torch.core.engine.driver import RoundState
from repro_torch.core.scoring import ScoreState
from repro_torch.utils import derived_seed, flat_update_dim


def params_from_reference(tree_of_numpy: Dict[str, Any], device, *,
                          model) -> Dict[str, Any]:
    """Nested dict of numpy arrays (the JAX package's params) -> nested
    dict of tensors on ``device``, each leaf in its dtype in
    ``model.param_dtypes()``: the model's dtype, and f32 for the LMs'
    RMSNorm scales, the MoE router and the mamba block's ``dt_bias``,
    ``A_log`` and ``D``, which the reference keeps in f32 in a bf16
    model. The decoder's tree is the reference's, period slots and all
    (``layers/slot_0 .. slot_{period-1}``), a vlm's ``patch_proj`` among
    them; so is the encdec's (``encoder`` / ``decoder`` stacks, f32
    LayerNorm scales and biases, ``dec_pos`` of as many rows as
    ``model.max_target_positions`` gives).
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


def _reference_manifest_mismatches(saved: dict, trainer) -> list:
    """What a reference run's manifest and ``trainer``'s disagree on,
    over the fields the two packages share."""
    mine = trainer.manifest()
    # remat is a field of both, read by neither package's round
    train = sorted((set(mine["train"]) & set(saved.get("train", {})))
                   - {"remat"})

    def shared(m):
        return {"arch": m.get("arch"), "model": m.get("model"),
                "fed": m.get("fed"), "use_trust": m.get("use_trust"),
                "train": {k: m.get("train", {}).get(k) for k in train}}

    return manifest_mismatches(shared(saved), shared(mine))


def state_from_reference_checkpoint(path: str, trainer) -> RoundState:
    """A checkpoint the reference's ``CheckpointManager`` wrote (``path``,
    a ``ckpt_*.npz``), read with numpy alone by path string, as
    ``trainer``'s :class:`RoundState`: the params, the scores with tester
    trust and ``rounds_seen``, ``round_idx`` and the error feedback, each
    as the reference stored it.

    The reference's ``.key`` is dropped, since the port does not draw
    threefry: the generator is seeded from (``fed.seed``, ``round_idx``),
    so the run continues on the port's own stream, not the reference's.

    When the directory holds the reference's ``manifest.json``, it must
    agree with ``trainer``'s on ``arch``, ``model`` (the two packages'
    ``ModelConfig`` have the same fields), ``fed``, ``use_trust`` and the
    ``train`` fields both packages have; ``ValueError`` names what
    differs. Not compared: ``train.seed``, which the port's
    ``TrainConfig`` lacks; ``train.remat``, which neither package's round
    reads (the reference's train CLI saves False, the port's default is
    the reference's ``TrainConfig`` default, True); ``family``
    (``model.family`` holds it) and ``manifest_version``."""
    man = os.path.join(os.path.dirname(os.path.abspath(path)), MANIFEST_NAME)
    if os.path.exists(man):
        with open(man) as f:
            diffs = _reference_manifest_mismatches(json.load(f), trainer)
        if diffs:
            raise ValueError("reference checkpoint is from another run:\n  "
                             + "\n  ".join(diffs))
    leaves = read_leaves(path)
    dev = trainer.device
    fed = trainer.fed
    round_idx = int(leaves[".round_idx"])
    comp = leaves.get(".comp_state")
    if (comp is not None) != trainer.program.use_compression:
        raise ValueError(f"the reference checkpoint's error feedback "
                         f"({'present' if comp is not None else 'absent'}) "
                         f"does not fit compressor {fed.compressor!r}")
    for p in (".scores/.scores", ".scores/.tester_trust"):
        if leaves[p].shape != (fed.num_users,):
            raise ValueError(f"{p} shape {leaves[p].shape} != "
                             f"({fed.num_users},)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(derived_seed(fed.seed, round_idx))
    return RoundState(
        global_params=params_from_reference(params_tree(leaves), dev,
                                            model=trainer.model),
        scores=ScoreState(
            scores=torch.tensor(leaves[".scores/.scores"],
                                dtype=torch.float32, device=dev),
            rounds_seen=torch.tensor(leaves[".scores/.rounds_seen"],
                                     dtype=torch.int32, device=dev),
            tester_trust=torch.tensor(leaves[".scores/.tester_trust"],
                                      dtype=torch.float32, device=dev)),
        round_idx=round_idx, gen=gen,
        comp_state=(None if comp is None else comp_state_from_reference(
            comp, dev, model=trainer.model, num_users=fed.num_users)),
        seed=fed.seed)
