"""Roofline terms from a dry-run's per-device counts (the port's side of
``repro/roofline/analysis.py``).

The reference reads its counts off the compiled program: FLOPs and bytes
from XLA's ``cost_analysis``, collective bytes parsed from the
partitioned HLO, temporaries from ``memory_analysis``. The port has no
compiled program; :class:`CostCounter`, a dispatch mode, counts the aten
ops one device runs as the step executes on DTensors of fake tensors:

* FLOPs of the local shards' products (``torch.utils.flop_counter``'s
  formulas: matmuls, batched matmuls, convolutions, attention), on the
  shapes one device computes, not the global shapes the DTensor op
  names;
* bytes accessed: every input read once and every output written once,
  op by op (a view moves nothing). Where XLA counts a fused kernel's
  operands, this counts each unfused op's, so it is larger;
* collectives: the per-device output bytes of each ``c10d_functional``
  collective, under the reference's op names (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), the dict ``collective_bytes_per_device`` and
  the report read;
* the peak of live intermediate bytes, the outputs the step's ops made
  and still holds (the twin of ``temp_size_in_bytes``).

    compute_term    = flops / peak_flops_bf16          [s]
    memory_term     = bytes / hbm_bw                   [s]
    collective_term = coll_bytes_per_dev / link_bw     [s]

The counts arrive per device, so ``per_device=True`` does not divide by
the chip count again. :func:`roofline_terms`, :func:`model_flops` and
:func:`collective_bytes_per_device` are the reference's arithmetic.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# c10d_functional op name -> the reference's HLO collective name
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_FUNCTIONAL = ("_c10d_functional", "c10d_functional")
# factories whose output holds nothing written: no bytes moved
_EMPTY = ("empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts one device's work while active (see the module's
    docstring): ``flops``, ``bytes``, ``collectives`` (name -> bytes),
    ``peak_temp_bytes`` and ``ops``.

    A DTensor op is counted through the local ops DTensor runs for it:
    the mode defers the DTensor-level call to DTensor, which redistributes
    (the collectives) and runs each op on the local shards, back through
    the mode. DTensor also runs an op once on global-shape stand-ins to
    learn its output's shape; those calls act on tensors made for the
    purpose, not on any local shard or anything computed from one, and
    are not counted: an op counts when one of its tensor arguments is a
    local shard the mode has seen, or an output of a counted op, or when
    it is a factory (other than an empty one) outside DTensor."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {}
        self.ops = 0
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self._local_ids: Dict[int, weakref.ref] = {}

    # tensors hash by identity but compare elementwise: keep them by id
    def _track(self, t: torch.Tensor) -> None:
        key = id(t)
        if key not in self._local_ids:
            self._local_ids[key] = weakref.ref(
                t, lambda _, key=key: self._local_ids.pop(key, None))

    def _known(self, t: torch.Tensor) -> bool:
        ref = self._local_ids.get(id(t))
        return ref is not None and ref() is t

    def _hold(self, t: torch.Tensor) -> None:
        """Count ``t`` live until it is freed."""
        n = _nbytes(t)
        self.live_bytes += n
        self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)
        weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def track_inputs(self, tree) -> None:
        """Mark the local shards of the DTensors in ``tree`` (params,
        batch, cache) as the device's own."""
        from torch.distributed.tensor import DTensor
        for leaf in tree_flatten(tree)[0]:
            if isinstance(leaf, DTensor):
                self._track(leaf._local_tensor)
            elif isinstance(leaf, torch.Tensor):
                self._track(leaf)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            for leaf in tree_flatten((args, kwargs))[0]:
                if isinstance(leaf, DTensor):
                    self._track(leaf._local_tensor)
            return NotImplemented
        out = func(*args, **kwargs)
        tensors = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        name = func._schema.name.split("::")[-1]
        if tensors:
            if not any(self._known(t) for t in tensors):
                return out                  # DTensor's shape inference
        elif name in _EMPTY or func is torch.ops.prim.device.default:
            return out
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if not outs:                 # prim.device, a scalar read: no work
            return out
        for o in outs:
            self._track(o)
        self.ops += 1
        namespace = func.namespace
        if namespace in _FUNCTIONAL:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.collectives[kind] = (self.collectives.get(kind, 0)
                                          + sum(_nbytes(o) for o in outs))
            return out
        packet = func.overloadpacket
        if packet in self._formulas:
            self.flops += int(self._formulas[packet](*args, **kwargs,
                                                     out_val=out))
        if not func.is_view:
            self.bytes += (sum(_nbytes(t) for t in tensors)
                           + sum(_nbytes(o) for o in outs))
            for o in outs:
                if not any(o is t for t in tensors):    # not in place
                    self._hold(o)
        return out

    def summary(self) -> Dict[str, object]:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": dict(self.collectives),
                "coll_bytes": collective_bytes_per_device(self.collectives),
                "peak_temp_bytes": self.peak_temp_bytes, "ops": self.ops}


def collective_bytes_per_device(colls: Dict[str, int]) -> float:
    factors = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}
    return sum(b * factors.get(op, 1.0) for op, b in colls.items())


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float, chip, num_chips: int,
                   per_device: bool = True) -> Dict[str, float]:
    div = 1 if per_device else num_chips
    compute = flops / div / chip.peak_flops_bf16
    memory = bytes_accessed / div / chip.hbm_bw
    collective = coll_bytes / chip.ici_link_bw
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    return terms


def model_flops(cfg, shape, active: bool = True) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for inference steps
    (N = (active) params, D = tokens processed)."""
    n = cfg.active_param_count() if active else cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens
