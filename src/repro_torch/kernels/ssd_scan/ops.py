"""Public SSD-scan op (counterpart of ``repro/kernels/ssd_scan/ops.py``).

``ssd_scan`` routes by the device of its inputs alone: CUDA tensors go to
the hand-written kernel (``csrc/ssd_scan.cu``), CPU tensors to the
sequential plain version in ``ref.py``. There is no fallback between the
two: a CUDA input the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.ssd_scan.ref import ssd_ref

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
HEAD_DIMS = (32, 64)
STATE_SIZES = (16, 128)
MAX_CHUNK = 1024


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("ssd_scan"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, B, C, D, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 4:
        raise ValueError(f"ssd_scan wants x [Bt,S,H,P], dt [Bt,S,H] and B, C "
                         f"[Bt,S,G,N], got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(B.shape)}")
    Bt, S, H, _ = x.shape
    G = B.shape[2]
    if (tuple(dt.shape) != (Bt, S, H) or tuple(B.shape[:2]) != (Bt, S)
            or C.shape != B.shape or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,)):
        raise ValueError(f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)}")
    if S < 1 or H % G:
        raise ValueError(f"ssd_scan needs S >= 1 and H a multiple of G, got "
                         f"S={S}, H={H}, G={G}")
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    if x.dtype not in _ENTRY or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, B, C of one "
                        f"dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if not dt.dtype == A.dtype == D.dtype == torch.float32:
        raise TypeError(f"ssd_scan takes float32 dt, A, D, got {dt.dtype}, "
                        f"{A.dtype}, {D.dtype}")
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError("ssd_scan's inputs lie on more than one device")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan over chunks of ``chunk`` rows (any S: the last chunk
    may be ragged). Shapes as in ``ref.ssd_ref``; returns (y [Bt,S,H,P]
    in x's dtype, final state [Bt,H,P,N] f32). x, B and C are read through
    their strides, so slices of a wider tensor need no copy, as long as
    their last dimension is unit-stride. Each launch of the CUDA kernel
    adds one to ``ssd_scan.launches``."""
    _check(x, dt, A, B, C, D, chunk)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, B, C, D)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if P not in HEAD_DIMS or N not in STATE_SIZES:
        raise ValueError(f"the CUDA ssd_scan takes head dim P in {HEAD_DIMS} "
                         f"and state N in {STATE_SIZES}, got P={P}, N={N}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"the CUDA ssd_scan takes chunk <= {MAX_CHUNK}, got "
                         f"{chunk}")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("ssd_scan needs x, B and C unit-stride in their "
                         "last dimension")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssd_scan needs contiguous A and D")
    y = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        *y.stride()[:3])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel(x.dtype)(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              B.data_ptr(), C.data_ptr(), D.data_ptr(),
                              y.data_ptr(), state.data_ptr(), Bt, S, H, G, P,
                              N, chunk, strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{rc} (x {tuple(x.shape)}, B {tuple(B.shape)}, "
                           f"chunk {chunk}, {x.dtype})")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
