"""Public fused dequantise-aggregate op: the int8 compressor's server step
(counterpart of ``repro/kernels/dequant_aggregate/ops.py``).

``dequant_aggregate`` routes by the device of its inputs alone: CUDA
tensors go to the hand-written kernel (``csrc/dequant_aggregate.cu``),
CPU tensors to the plain version in ``ref.py``. There is no fallback
between the two: a CUDA input the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.dequant_aggregate.ref import dequant_aggregate_ref


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("dequant_aggregate").dequant_aggregate_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dequant_aggregate(w: torch.Tensor, scales: torch.Tensor,
                      q: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """w [C] f32; scales [C, M/chunk] f32; q [C, M] int8 -> [M] f32.

    ``M`` must be a whole number of chunks (the int8 compressor pads at
    encode time). Each launch of the CUDA kernel adds one to
    ``dequant_aggregate.launches``. A CUDA graph's replay launches the
    kernel without calling this wrapper and adds nothing: count a
    replay's launches from a profiler trace.
    """
    if q.dim() != 2 or chunk <= 0:
        raise ValueError(f"dequant_aggregate wants q [C, M] and a positive "
                         f"chunk, got {tuple(q.shape)} and {chunk}")
    C, M = q.shape
    if M % chunk != 0:
        raise ValueError(f"M={M} must be a multiple of chunk={chunk}")
    if scales.shape != (C, M // chunk):
        raise ValueError(
            f"scales shape {tuple(scales.shape)} != {(C, M // chunk)}")
    if w.shape != (C,):
        raise ValueError(f"w shape {tuple(w.shape)} != {(C,)}")
    if (q.dtype != torch.int8 or scales.dtype != torch.float32
            or w.dtype != torch.float32):
        raise TypeError(f"dequant_aggregate takes q int8, scales and w "
                        f"float32, got {q.dtype}, {scales.dtype} and "
                        f"{w.dtype}")
    if not w.device == scales.device == q.device:
        raise ValueError(f"w on {w.device}, scales on {scales.device}, q on "
                         f"{q.device}")
    if q.device.type == "cpu":
        return dequant_aggregate_ref(w, scales, q, chunk)
    if q.device.type != "cuda":
        raise ValueError(f"dequant_aggregate runs on cuda or cpu, not "
                         f"{q.device}")
    if not (q.is_contiguous() and scales.is_contiguous()
            and w.is_contiguous()):
        raise ValueError("dequant_aggregate needs contiguous w, scales and q")
    out = torch.empty((M,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(w.data_ptr(), scales.data_ptr(), q.data_ptr(),
                       out.data_ptr(), C, M, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"dequant_aggregate kernel launch failed with "
                           f"CUDA error {rc} (C={C}, M={M}, chunk={chunk})")
    dequant_aggregate.launches += 1
    return out


dequant_aggregate.launches = 0
