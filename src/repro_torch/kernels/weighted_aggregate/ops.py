"""Public weighted-aggregation ops (array- and tree-level).

``weighted_aggregate`` and ``aggregate_pytree`` route by the device of
their inputs alone: CUDA tensors go to the hand-written kernel
(``csrc/weighted_aggregate.cu``), CPU tensors to the plain version in
``ref.py``. There is no fallback between the two: a CUDA input the kernel
cannot take raises. On the card a whole tree is reduced in one launch a
table of up to :data:`TABLE` leaves (:func:`plan_launches`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.weighted_aggregate.ref import weighted_aggregate_ref
from repro_torch.utils import tree_leaves, tree_map

_ENTRY = {torch.float32: "weighted_aggregate_f32",
          torch.bfloat16: "weighted_aggregate_bf16"}
# the kernel's constants: leaves a launch's table holds (kMaxLeaves),
# threads a block (kThreads), and the columns a thread takes where a
# leaf allows 16-byte loads (VEC, by dtype)
TABLE = 64
THREADS = 256
VEC = {torch.float32: 4, torch.bfloat16: 8}


class Launch(NamedTuple):
    """One grouped launch: ``leaves`` index the planned leaves, ``units``
    are the columns a thread of each takes (VEC or 1), and leaf ``j`` owns
    blocks ``first_block[j]`` up to ``first_block[j + 1]``."""
    leaves: Tuple[int, ...]
    units: Tuple[int, ...]
    first_block: Tuple[int, ...]


def plan_launches(sizes: Sequence[int], aligned: Sequence[bool],
                  vec: int) -> List[Launch]:
    """Split leaves of widths ``sizes`` (each > 0) into launches of at most
    :data:`TABLE` leaves, in order. A leaf takes ``vec`` columns a thread
    where its width is a multiple of ``vec`` and ``aligned`` says both of
    its pointers are 16-byte aligned, else one; it gets whole blocks of
    :data:`THREADS` threads, enough for all its columns."""
    launches = []
    for start in range(0, len(sizes), TABLE):
        leaves = tuple(range(start, min(start + TABLE, len(sizes))))
        units = tuple(vec if aligned[i] and sizes[i] % vec == 0 else 1
                      for i in leaves)
        prefix = [0]
        for i, unit in zip(leaves, units):
            chunks = -(-sizes[i] // unit)
            prefix.append(prefix[-1] - (-chunks // THREADS))
        launches.append(Launch(leaves, units, tuple(prefix)))
    return launches


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("weighted_aggregate"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _group_kernel(dtype: torch.dtype):
    fn = getattr(load_library("weighted_aggregate"),
                 _ENTRY[dtype].replace("aggregate_", "aggregate_group_"))
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.shape != (x.shape[0],):
        raise ValueError(f"weighted_aggregate wants x [C, M] and w [C], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _ENTRY or w.dtype != torch.float32:
        raise TypeError(f"weighted_aggregate takes x float32|bfloat16 and w "
                        f"float32, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"weighted_aggregate runs on cuda or cpu, not "
                         f"{x.device}")
    if x.device.type == "cuda" and not (x.is_contiguous()
                                        and w.is_contiguous()):
        raise ValueError("weighted_aggregate needs contiguous x and w")


def weighted_aggregate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [C, M] (float32 | bfloat16); w [C] float32 -> [M] in x.dtype.

    Each launch of the CUDA kernel adds one to ``weighted_aggregate.launches``.
    """
    _check(x, w)
    if x.device.type == "cpu":
        return weighted_aggregate_ref(x, w)
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


@functools.lru_cache(maxsize=64)
def _planned(sizes: Tuple[int, ...], aligned: Tuple[bool, ...], vec: int):
    """The plan of one tree, with each launch's host arrays of widths,
    units and block prefix built once: a round reuses them."""
    return [(launch.leaves,
             (ctypes.c_longlong * len(launch.leaves))(
                 *(sizes[i] for i in launch.leaves)),
             (ctypes.c_int * len(launch.leaves))(*launch.units),
             (ctypes.c_int * len(launch.first_block))(*launch.first_block))
            for launch in plan_launches(sizes, aligned, vec)]


def _aggregate_group(xs: List[torch.Tensor], w: torch.Tensor
                     ) -> List[torch.Tensor]:
    """Each ``[C, M_i]`` of ``xs`` (one dtype, on the card) reduced by the
    grouped kernel, one launch a table; each launch adds one to
    ``weighted_aggregate.launches``. The outputs are slices of one
    buffer, each starting on a 16-byte boundary."""
    dtype, C = xs[0].dtype, w.shape[0]
    align = 16 // xs[0].element_size()
    starts, total = [], 0
    for x in xs:
        starts.append(total)
        total += -(-x.shape[1] // align) * align
    buf = torch.empty((total,), dtype=dtype, device=w.device)
    outs = [buf[s:s + x.shape[1]] for s, x in zip(starts, xs)]
    plan = _planned(tuple(x.shape[1] for x in xs),
                    tuple(x.data_ptr() % 16 == 0 for x in xs), VEC[dtype])
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        for leaves, widths, units, first_block in plan:
            n = len(leaves)
            rc = _group_kernel(dtype)(
                (ctypes.c_void_p * n)(*(xs[i].data_ptr() for i in leaves)),
                (ctypes.c_void_p * n)(*(outs[i].data_ptr() for i in leaves)),
                widths, units, first_block, n, w.data_ptr(), C, stream)
            if rc != 0:
                raise RuntimeError(
                    f"weighted_aggregate grouped kernel launch failed with "
                    f"CUDA error {rc} ({n} leaves, C={C}, {dtype})")
            weighted_aggregate.launches += 1
    return outs


def aggregate_pytree(stacked, w: torch.Tensor):
    """Score-weighted reduction of a client-stacked param tree: leaves
    ``[C, ...]`` -> the aggregated tree without that axis (Algorithm 1,
    line 14). On the CPU one plain reduction a leaf; on the card the
    leaves of each dtype go to the grouped kernel, one launch a table of
    up to :data:`TABLE` leaves (one a round for ``fedtest-cnn``)."""
    leaves = tree_leaves(stacked)
    flat = [x.reshape(x.shape[0], -1) for x in leaves]
    for x in flat:
        _check(x, w)
    if w.device.type == "cpu":
        outs = [weighted_aggregate_ref(x, w) for x in flat]
    else:
        # empty leaves need no launch; the rest go by dtype
        outs = [x.new_empty((0,)) if x.shape[1] == 0 else None for x in flat]
        for dtype in _ENTRY:
            idx = [i for i, x in enumerate(flat)
                   if x.dtype == dtype and outs[i] is None]
            if idx:
                for i, out in zip(idx, _aggregate_group(
                        [flat[i] for i in idx], w)):
                    outs[i] = out
    shaped = iter(out.reshape(x.shape[1:]) for out, x in zip(outs, leaves))
    return tree_map(lambda _: next(shaped), stacked)
