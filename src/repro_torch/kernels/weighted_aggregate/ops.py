"""Public weighted-aggregation ops (array- and tree-level).

``weighted_aggregate`` routes by the device of its input alone: a CUDA
tensor goes to the hand-written kernel (``csrc/weighted_aggregate.cu``),
a CPU tensor to the plain version in ``ref.py``. There is no fallback
between the two: a CUDA input the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.weighted_aggregate.ref import weighted_aggregate_ref
from repro_torch.utils import tree_map

_ENTRY = {torch.float32: "weighted_aggregate_f32",
          torch.bfloat16: "weighted_aggregate_bf16"}


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("weighted_aggregate"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def weighted_aggregate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [C, M] (float32 | bfloat16); w [C] float32 -> [M] in x.dtype.

    Each launch of the CUDA kernel adds one to ``weighted_aggregate.launches``.
    """
    if x.dim() != 2 or w.shape != (x.shape[0],):
        raise ValueError(f"weighted_aggregate wants x [C, M] and w [C], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _ENTRY or w.dtype != torch.float32:
        raise TypeError(f"weighted_aggregate takes x float32|bfloat16 and w "
                        f"float32, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.device.type == "cpu":
        return weighted_aggregate_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"weighted_aggregate runs on cuda or cpu, not "
                         f"{x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("weighted_aggregate needs contiguous x and w")
    C, M = x.shape
    out = torch.empty((M,), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel(x.dtype)(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              C, M, stream)
    if rc != 0:
        raise RuntimeError(f"weighted_aggregate kernel launch failed with "
                           f"CUDA error {rc} (C={C}, M={M}, {x.dtype})")
    weighted_aggregate.launches += 1
    return out


weighted_aggregate.launches = 0


def aggregate_pytree(stacked, w: torch.Tensor):
    """Score-weighted reduction of a client-stacked param tree: leaves
    ``[C, ...]`` -> the aggregated tree without that axis, one
    :func:`weighted_aggregate` call per leaf (Algorithm 1, line 14)."""
    def _leaf(x):
        return weighted_aggregate(x.reshape(x.shape[0], -1),
                                  w).reshape(x.shape[1:])
    return tree_map(_leaf, stacked)
