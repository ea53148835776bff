"""Shape stand-ins and sharding specs for every (architecture x input
shape) combination, the dry-run's contract (the port's side of
``repro/launch/specs.py``).

Nothing here allocates: a stand-in is a fake tensor on the ``cpu``
device (``FakeTensorMode``, the twin of ``jax.ShapeDtypeStruct``), made
under the ``mode`` a caller passes (a fresh one by default); the cache's
come from the real cache constructors run under it (the twin of
``jax.eval_shape``). Stand-ins sit on ``cpu``, not ``meta``, because the
kernel ops refuse ``meta`` and take their plain route on ``cpu``; the
model is the differentiable one (``Model.differentiable``), whose
full-sequence attention and scan are the blockwise twins, as the
reference's dry-run takes XLA's path off the TPU. The port's layer
stacks are Python loops, not scans, so the reference's ``unroll`` has no
counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import InputShape, ModelConfig, TrainConfig
from repro_torch.models import build_model
from repro_torch.models import decoder as dec_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models.frontend_stub import stub_spec
from repro_torch.optim import make_optimizer
from repro_torch.sharding import (
    axis_sizes, guard_divisibility, make_ruleset, param_spec_tree,
    to_placements)
from repro_torch.utils import tree_map

# sliding window applied to full-attention archs for the long_500k shape
LONG_CONTEXT_WINDOW = 16_384


def model_for(cfg: ModelConfig, shape: InputShape, **model_kw):
    """Model variant serving this workload shape (DESIGN.md §5);
    ``model_kw`` overrides its fields (a perf variant's knobs)."""
    kw: Dict = {"differentiable": True}
    if cfg.family == "encdec":
        kw["max_target_positions"] = shape.seq_len + 1
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        kw["sliding_window"] = LONG_CONTEXT_WINDOW
    kw.update(model_kw)
    return build_model(cfg, **kw)


def supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, ("whisper decoder has a hard 448-position ceiling and "
                       "no sub-quadratic variant (DESIGN.md §5)")
    return True, ""


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="cpu")


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                mode: Optional[FakeTensorMode] = None
                ) -> Dict[str, torch.Tensor]:
    """Batch stand-ins for the *step function* of this shape's kind."""
    mode = mode or FakeTensorMode()
    model = model_for(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    with mode:
        if shape.kind == "decode":
            # one new token against a cache filled to capacity-1
            return {"tokens": _empty((B, 1), i32)}
        batch: Dict[str, torch.Tensor] = {}
        text = S
        if cfg.family == "vlm":
            text = S - cfg.num_patches
            batch["patches"] = stub_spec(cfg, B, model.dtype, mode=mode)
        elif cfg.family == "encdec":
            batch["frames"] = stub_spec(cfg, B, model.dtype, mode=mode)
        batch["tokens"] = _empty((B, text), i32)
        if shape.kind == "train":
            batch["labels"] = _empty((B, text), i32)
        return batch


def cache_specs(cfg: ModelConfig, shape: InputShape, *,
                mode: Optional[FakeTensorMode] = None):
    """The decode cache's stand-ins, filled to capacity - 1."""
    model = model_for(cfg, shape)
    B, cap = shape.global_batch, shape.seq_len
    mod = encdec_mod if cfg.family == "encdec" else dec_mod
    with mode or FakeTensorMode():
        return mod.make_empty_cache(cfg, B, cap, model.dtype,
                                    length=cap - 1, device="cpu")


def params_and_opt_specs(cfg: ModelConfig, shape: InputShape,
                         train_cfg: Optional[TrainConfig] = None, *,
                         mode: Optional[FakeTensorMode] = None):
    """Stand-ins for the params (and the optimizer state for training)."""
    model = model_for(cfg, shape)
    with mode or FakeTensorMode():
        params = tree_map(_empty, model.param_shapes(), model.param_dtypes())
        if shape.kind != "train":
            return params, None
        opt = make_optimizer(train_cfg or TrainConfig())
        return params, opt.init(params)


# ------------------------------------------------------------- sharding specs
def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def activation_rules(cfg: ModelConfig, shape: InputShape, mesh):
    sizes = axis_sizes(mesh)
    n_batch_shards = 1
    for a in batch_axes(mesh):
        n_batch_shards *= sizes[a]
    divisible = shape.global_batch % n_batch_shards == 0
    return make_ruleset(tuple(mesh.mesh_dim_names), kind=shape.kind,
                        batch_divisible=divisible)


def batch_spec_tree(cfg: ModelConfig, shape: InputShape, mesh, specs):
    b = activation_rules(cfg, shape, mesh)["batch"]
    out = {name: (b,) + (None,) * (s.ndim - 1) for name, s in specs.items()}
    return guard_divisibility(out, specs, mesh)


def cache_spec_tree(cfg: ModelConfig, shape: InputShape, mesh, cache):
    rules = activation_rules(cfg, shape, mesh)
    b, kvs = rules["batch"], rules["kv_seq"]

    def _spec(names, leaf):
        leafname = names[-1] if names else ""
        if leafname == "length":
            return (b,)
        if "cross" in names:               # [L, B, T_enc, Hkv, dh]
            return (None, b, None, None, None)
        if leafname in ("k", "v"):         # [L|P, B, cap, Hkv, dh]
            return (None, b, kvs, None, None)
        if leafname == "conv":             # [P, B, W-1, conv_dim]
            return (None, b, None, "model")
        if leafname == "ssm":              # [P, B, H, Pd, N]
            return (None, b, "model", None, None)
        return (None,) * leaf.ndim

    def walk(tree, names=()):
        if isinstance(tree, dict):
            return {k: walk(v, names + (k,)) for k, v in tree.items()}
        return _spec(names, tree)

    return guard_divisibility(walk(cache), cache, mesh)


def param_sharding_tree(cfg: ModelConfig, mesh, params):
    spec = param_spec_tree(params, tuple(mesh.mesh_dim_names))
    return guard_divisibility(spec, params, mesh)


def to_named(mesh, spec_tree):
    """Each spec's DTensor placements on ``mesh`` (the twin of the
    reference's ``NamedSharding`` tree)."""
    return tree_map(lambda s: to_placements(s, mesh), spec_tree)


def distribute(mesh, spec_tree, tree, mode: FakeTensorMode):
    """``tree``'s stand-ins as DTensors on ``mesh`` with the placements of
    ``spec_tree``: each device holds its local shard, a fake tensor of
    ``mode``."""
    from torch.distributed.tensor import distribute_tensor
    with mode:
        return tree_map(lambda t, pl: distribute_tensor(t, mesh, pl), tree,
                        to_named(mesh, spec_tree))
