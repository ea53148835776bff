"""Public decode-attention op and the LSE merge of partials (counterpart
of ``repro/kernels/decode_attention/ops.py``).

``decode_attention`` routes by the device of its inputs alone: CUDA
tensors go to the hand-written split-K kernel and its merge kernel
(``csrc/decode_attention.cu``), CPU tensors to the plain version in
``ref.py``. There is no fallback between the two: a CUDA input the
kernels cannot take raises. ``merge_partials`` is plain torch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8          # query heads a KV head, the largest the kernel takes
BLOCKS_PER_SM = 8      # split blocks the plan aims at for each SM
MIN_SPLIT_KEYS = 128   # keys a split takes at the least: two 64-key tiles


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("decode_attention"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_splits(B: int, Hkv: int, T: int, sms: int) -> int:
    """Key splits a (b, KV head): enough blocks for ``BLOCKS_PER_SM`` a
    streaming multiprocessor (about three are resident at once, so the
    later ones fill the gaps the first ones leave), but no split under
    ``MIN_SPLIT_KEYS`` keys, so that a block's ring has a tile to load
    while it computes another."""
    want = math.ceil(BLOCKS_PER_SM * sms / (B * Hkv))
    return max(1, min(want, math.ceil(T / MIN_SPLIT_KEYS)))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: Optional[float] = None,
                     window: Optional[int] = None):
    """q [B,Hq,D]; cache k, v [B,T,Hkv,D]; lengths [B] -> (out [B,Hq,D] in
    q's dtype, lse [B,Hq] f32). Sequence b attends keys t < lengths[b]
    (and t >= lengths[b] - window with a window).

    Each launch of the CUDA split kernel adds one to
    ``decode_attention.launches``, and of its merge kernel one to
    ``decode_attention.merge_launches``. A CUDA graph's replay launches
    both without calling this wrapper and adds nothing: count a
    replay's launches from a profiler trace.
    """
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention wants q [B,Hq,D] and k, v "
                         f"[B,T,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share B and D, or Hq is not a multiple of Hkv")
    if lengths.shape != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != {(B,)}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q, k, "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be None or >= 1")
    if not q.device == k.device == v.device == lengths.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}, lengths on {lengths.device}")
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, scale=scale,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if D not in HEAD_DIMS or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"the CUDA decode_attention takes head_dim in "
                         f"{HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"a KV head, got D={D}, Hq/Hkv={Hq // Hkv}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32 on cuda, got {lengths.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("decode_attention needs contiguous q, k, v and "
                         "lengths")
    if k.data_ptr() % 16 or v.data_ptr() % 16 or (
            q.dtype == torch.bfloat16 and q.data_ptr() % 16):
        raise ValueError("decode_attention needs k and v (and a bf16 q) on "
                         "16-byte aligned addresses")
    rep = Hq // Hkv
    splits = num_splits(B, Hkv, T, _sm_count(q.device.index))
    part_acc = torch.empty((B, Hkv, splits, rep, D), dtype=torch.float32,
                           device=q.device)
    part_m = torch.empty((B, Hkv, splits, rep), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              lengths.data_ptr(), out.data_ptr(),
                              lse.data_ptr(), part_acc.data_ptr(),
                              part_m.data_ptr(), part_l.data_ptr(), B, Hq, T,
                              Hkv, D, splits, strides, float(scale),
                              int(window or 0), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with "
                           f"CUDA error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}, {splits} splits)")
    decode_attention.launches += 1
    decode_attention.merge_launches += 1
    return out, lse


decode_attention.launches = 0
decode_attention.merge_launches = 0


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """LSE-weighted merge of per-shard partial attentions: outs
    [S, B, H, D] and lses [S, B, H] stacked over shards -> out [B, H, D]
    in outs' dtype. Shards with no valid key carry lse = -inf (or the
    kernel's -1e30) and drop out."""
    m = lses.amax(dim=0, keepdim=True)
    w = torch.exp(lses - m)
    denom = w.sum(dim=0).clamp(min=1e-30)
    out = (outs.float() * w[..., None]).sum(dim=0) / denom[..., None]
    return out.to(outs.dtype)
