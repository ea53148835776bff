"""Logical-axis sharding hints (the port's side of
``repro/sharding/hints.py``).

Model code tags activations with *logical* axis names,
``shard_hint(x, ("batch", "seq", "embed"))``. The dry-run activates a rule
set (logical name -> mesh axes) with ``logical_rules(...)``; there a hint
redistributes a DTensor to the placements its spec names (the twin of
``with_sharding_constraint``). Outside a rule context, or on a plain
tensor, a hint returns its input: the round, serve and chunk paths run
the same model code unchanged.

A spec is a tuple with one entry a tensor dimension: ``None``
(replicated), a mesh-axis name, or a tuple of them (the twin of a
``PartitionSpec``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]

_state = threading.local()


def current_rules() -> Optional[Dict[str, Axis]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_rules(rules: Dict[str, Axis]):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Dict[str, Axis]] = None) -> tuple:
    rules = rules if rules is not None else (current_rules() or {})
    return tuple(rules.get(a) if a is not None else None
                 for a in logical_axes)


def is_sharded(x) -> bool:
    """True for a DTensor under active rules (the dry-run)."""
    if current_rules() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_hint(x: torch.Tensor, logical_axes: Sequence[Optional[str]]):
    """``x`` redistributed to the placements ``logical_axes`` name under
    the active rules (``x`` itself outside them or for a plain tensor). A
    mesh axis that does not divide its dimension is dropped, as
    ``guard_divisibility`` drops it from a param spec: DTensor views split
    a sharded dimension only evenly, where XLA pads."""
    if not is_sharded(x):
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"hint {tuple(logical_axes)} for a tensor of "
                         f"shape {tuple(x.shape)}")
    from repro_torch.sharding.rules import guard_spec, to_placements
    mesh = x.device_mesh
    spec = guard_spec(spec_for(logical_axes, current_rules()), x.shape, mesh)
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def per_device(fn, inputs, outputs, **kw):
    """``fn(*tensors, **kw)``, where under the rules its DTensor inputs
    are computed shard by shard: ``fn`` is independent across the batch
    and across heads (attention, the SSD scan), so each device runs it on
    its own batch rows and heads, with no collective inside.

    ``inputs`` is ``[(tensor, batch_dim, heads_dim)]`` (``None`` where a
    tensor has no such dimension), the first the one whose layout leads:
    a mesh axis that shards its batch dimension shards every input's
    batch dimension, one that shards its heads shards every input's heads
    if it divides each one's head count, and every other axis replicates.
    ``outputs`` is ``[(batch_dim, heads_dim)]`` of ``fn``'s results (one
    tensor, or a tuple of them). Outside the rules, ``fn`` on the tensors
    as they are. Gradients flow through (``to_local`` / ``from_local``):
    an input replicated on an axis that splits the work gets a partial
    sum there, as each device's share of its gradient."""
    tensors = [t for t, _, _ in inputs]
    if not is_sharded(tensors[0]):
        return fn(*tensors, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lead, b0, h0 = inputs[0]
    mesh = lead.device_mesh
    roles = []
    for m, pl in enumerate(lead.placements):
        n = mesh.size(m)
        if b0 is not None and pl == Shard(b0):
            roles.append("batch")
        elif h0 is not None and pl == Shard(h0) and all(
                t.shape[h] % n == 0 for t, _, h in inputs if h is not None):
            roles.append("heads")
        else:
            roles.append(None)

    def layout(b, h):
        return [Shard(b) if role == "batch" and b is not None else
                Shard(h) if role == "heads" and h is not None else
                Replicate() for role in roles]

    def grads(placements):
        return [Partial() if role is not None and pl == Replicate() else pl
                for role, pl in zip(roles, placements)]

    local = []
    for t, b, h in inputs:
        placements = layout(b, h)
        local.append(t.redistribute(mesh, placements).to_local(
            grad_placements=grads(placements)))
    out = fn(*local, **kw)
    many = isinstance(out, tuple)
    wrapped = tuple(DTensor.from_local(o, mesh, layout(b, h),
                                       run_check=False)
                    for o, (b, h) in zip(out if many else (out,), outputs))
    return wrapped if many else wrapped[0]


def full_hint(shape, value, logical_axes: Sequence[Optional[str]], *,
              dtype, device=None, like=None) -> torch.Tensor:
    """``torch.full(shape, value)``; where ``like`` is a DTensor under the
    rules, a DTensor on its mesh laid out as ``logical_axes`` name (each
    device makes its own shard)."""
    if not is_sharded(like):
        return torch.full(shape, value, dtype=dtype, device=device)
    from torch.distributed import tensor as dtensor
    from repro_torch.sharding.rules import guard_spec, to_placements
    mesh = like.device_mesh
    spec = guard_spec(spec_for(logical_axes, current_rules()), shape, mesh)
    return dtensor.full(shape, value, dtype=dtype, device_mesh=mesh,
                        placements=to_placements(spec, mesh))


def arange_like(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.arange(x.shape[dim])`` on ``x``'s device; for a DTensor
    under the rules, a DTensor sharded as ``x``'s dimension ``dim`` is
    (each device holds its own indices) and replicated otherwise, so that
    comparing it with ``x`` moves nothing."""
    n = x.shape[dim]
    if not is_sharded(x):
        return torch.arange(n, device=x.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim = dim % x.ndim
    mesh = x.device_mesh
    on = [m for m, pl in enumerate(x.placements) if pl == Shard(dim)]
    local = x._local_tensor.shape[dim]
    offset = 0
    for m in on:
        offset = offset * mesh.size(m) + mesh.get_local_rank(m)
    ids = torch.arange(local, device=x.device) + offset * local
    placements = [Shard(0) if m in on else Replicate()
                  for m in range(mesh.ndim)]
    return DTensor.from_local(ids, mesh, placements, run_check=False,
                              shape=torch.Size([n]), stride=(1,))


def _view_groups(src, dst):
    """Pair the dims of a view from shape ``src`` to ``dst``: a list of
    (source dims, destination dims) whose sizes multiply alike."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj = [], []
        pi = pj = 1
        while True:
            if pi <= pj and i < len(src):
                pi *= src[i]
                gi.append(i)
                i += 1
            elif j < len(dst):
                pj *= dst[j]
                gj.append(j)
                j += 1
            else:
                break
            if pi == pj and (i == len(src) or src[i] != 1) and (
                    j == len(dst) or dst[j] != 1) and gi and gj:
                break
        groups.append((gi, gj))
    return groups


def sharded_reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)``; under the rules, a DTensor first gives up the
    shards of a dimension that the view cannot carry evenly (split with a
    leading size its mesh axes do not divide, or merged behind another
    dimension), so that DTensor can take the view."""
    if not is_sharded(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    shape = list(shape)
    if -1 in shape:
        k = shape.index(-1)
        rest = 1
        for n in shape[:k] + shape[k + 1:]:
            rest *= n
        shape[k] = x.numel() // rest
    mesh = x.device_mesh
    placements = list(x.placements)
    for gi, gj in _view_groups(list(x.shape), shape):
        for dim in gi:
            on = [m for m, pl in enumerate(placements)
                  if isinstance(pl, Shard) and pl.dim == dim]
            n = 1
            for m in on:
                n *= mesh.size(m)
            if on and (dim != gi[0] or not gj or shape[gj[0]] % n):
                for m in on:
                    placements[m] = Replicate()
    if placements != list(x.placements):
        x = x.redistribute(mesh, placements)
    return x.reshape(shape)
