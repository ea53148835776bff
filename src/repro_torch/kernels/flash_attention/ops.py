"""Public flash-attention op (counterpart of
``repro/kernels/flash_attention/ops.py``).

``flash_attention`` routes by the device of its inputs alone: CUDA
tensors go to the hand-written kernel (``csrc/flash_attention.cu``), CPU
tensors to the plain version in ``ref.py``. There is no fallback between
the two: a CUDA input the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention.ref import attention_ref

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("flash_attention"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,S,Hq,D]; k, v [B,T,Hkv,D] -> [B,S,Hq,D] in q's dtype.

    Query i sits at position i + q_offset and attends key t iff
    t <= i + q_offset (causal) and t > i + q_offset - sliding_window.
    Each launch of the CUDA kernel adds one to
    ``flash_attention.launches``.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q [B,S,Hq,D] and k, v "
                         f"[B,T,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share B and D, or Hq is not a multiple of Hkv")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window={sliding_window} must be None or "
                         ">= 1")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal,
                             sliding_window=sliding_window, scale=scale,
                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash_attention takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the bf16 flash_attention needs q, k and v on "
                         "16-byte aligned addresses")
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), B, S, T, Hq, Hkv, D, strides,
                              float(scale), int(causal),
                              int(sliding_window or 0), int(q_offset),
                              stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
