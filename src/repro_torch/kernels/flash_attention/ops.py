"""Public flash-attention op (counterpart of
``repro/kernels/flash_attention/ops.py``).

``flash_attention`` routes by the device of its inputs alone: CUDA
tensors go to the hand-written kernel (``csrc/flash_attention.cu``), CPU
tensors to the plain version in ``ref.py``. There is no fallback between
the two: a CUDA input the kernel cannot take raises.

The op is a ``torch.library`` custom op, so it runs under
``torch.func.vmap``: its vmap rule folds the batched dimensions (the
cross-test's testers and client models) into the op's batch and calls it
once, so a batched eval launches the kernel once a layer. It has no
gradient (the CUDA kernel, like the TPU kernel, is forward-only): under a
gradient it raises. :func:`blockwise_attention`, the twin of the
reference's ``attention_xla``, is the differentiable form local training
takes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import (
    batch_slices, divisor_block, load_library)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.sharding import sharded_reshape

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (32, 64, 128)
NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("flash_attention"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, window: int, scale: float,
            q_offset: int) -> torch.Tensor:
    """The CUDA kernel over q's batch, one launch a :func:`batch_slices`
    slice (a grid holds at most 65,535 batch rows)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
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
        for sl in batch_slices(B):
            rc = _kernel(q.dtype)(q[sl].data_ptr(), k[sl].data_ptr(),
                                  v[sl].data_ptr(), out[sl].data_ptr(),
                                  sl.stop - sl.start, S, T, Hq, Hkv, D,
                                  strides, scale, int(causal), window,
                                  q_offset, stream)
            if rc != 0:
                raise RuntimeError(
                    f"flash_attention kernel launch failed with CUDA error "
                    f"{rc} (q {tuple(q.shape)}, k {tuple(k.shape)}, rows "
                    f"{sl.start}:{sl.stop}, {q.dtype})")
            flash_attention.launches += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, scale: float,
              q_offset: int) -> torch.Tensor:
    """The op on whole tensors (``window`` 0 for none): the plain version
    on the CPU, slice by slice as the kernel launches, else the kernel."""
    if q.device.type == "cpu":
        return torch.cat([attention_ref(
            q[sl], k[sl], v[sl], causal=causal,
            sliding_window=window or None, scale=scale, q_offset=q_offset)
            for sl in batch_slices(q.shape[0])])
    return _launch(q, k, v, causal, window, scale, q_offset)


@_flash_op.register_fake
def _(q, k, v, causal, window, scale, q_offset):
    return torch.empty_like(q)


def _fold_rule(info, in_dims, q, k, v, causal, window, scale, q_offset):
    """vmap rule: the mapped dimension goes in front and folds into the
    batch, ``[n, B, ...] -> [n * B, ...]``, so the op (and the kernel)
    runs once for the whole map; nested maps fold level by level. An
    unbatched k or v is expanded to q's map; a batched k or v with an
    unbatched q is refused (no caller makes one). The fold's reshape may
    copy and the kernel reads whole rows, so what the rule hands on is
    made contiguous."""
    qd, kd, vd = in_dims[:3]
    if qd is None:
        raise ValueError("flash_attention under vmap maps q: a mapped k or v "
                         "with an unmapped q has no rule")
    n = info.batch_size

    def fold(t, d):
        t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
        return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()

    out = _flash_op(fold(q, qd), fold(k, kd), fold(v, vd), causal, window,
                    scale, q_offset)
    return out.reshape(n, -1, *out.shape[1:]), 0


_flash_op.register_vmap(_fold_rule)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,S,Hq,D]; k, v [B,T,Hkv,D] -> [B,S,Hq,D] in q's dtype.

    Query i sits at position i + q_offset and attends key t iff
    t <= i + q_offset (causal) and t > i + q_offset - sliding_window.
    Each launch of the CUDA kernel adds one to
    ``flash_attention.launches``; a batch over 65,535 rows takes one
    launch a slice of that many. A CUDA graph's replay launches the
    kernel without calling this wrapper and adds nothing: count a
    replay's launches from a profiler trace.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q [B,S,Hq,D] and k, v "
                         f"[B,T,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no gradient (the kernel is "
                           "forward-only); differentiate "
                           "blockwise_attention")
    if scale is None:
        scale = D ** -0.5
    return _flash_op(q, k, v, causal, int(sliding_window or 0), float(scale),
                     int(q_offset))


flash_attention.launches = 0


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sliding_window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0,
                        block_q: int = 512, block_k: int = 512
                        ) -> torch.Tensor:
    """Blockwise online-softmax attention in plain tensor ops, the twin of
    the reference's ``attention_xla`` and the form local training
    differentiates: the same layout as :func:`flash_attention`, blocks of
    the largest divisor of S (T) up to ``block_q`` (``block_k``), f32
    running max, sum and output, masked scores set to -1e30, the sum
    clamped at 1e-30. Python loops over the blocks, no in-place writes,
    so it runs under ``vmap`` of ``grad``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    block_q = divisor_block(S, block_q)
    block_k = divisor_block(T, block_k)
    nq, nk = S // block_q, T // block_k
    # [n_blocks, B, Hkv, rep|-, block, D]
    # (sharded_reshape is reshape outside the dry-run's sharding rules)
    qb = sharded_reshape(q, (B, nq, block_q, Hkv, rep, D)
                         ).permute(1, 0, 3, 4, 2, 5)
    kb = sharded_reshape(k, (B, nk, block_k, Hkv, D)).permute(1, 0, 3, 2, 4)
    vb = sharded_reshape(v, (B, nk, block_k, Hkv, D)).permute(1, 0, 3, 2, 4)
    qpos_base = torch.arange(block_q, device=q.device) + q_offset
    kpos_base = torch.arange(block_k, device=q.device)
    outs = []
    for qi in range(nq):
        qblk = qb[qi].float() * scale
        qpos = qpos_base + qi * block_q
        m = torch.full((B, Hkv, rep, block_q, 1), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, rep, block_q, 1), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Hkv, rep, block_q, D), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            s = torch.einsum("bgrqd,bgkd->bgrqk", qblk, kb[ki].float())
            kpos = kpos_base + ki * block_k
            mask = torch.ones((block_q, block_k), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if sliding_window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - sliding_window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bgrqk,bgkd->bgrqd", p,
                                            vb[ki].float())
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)).to(q.dtype))
    # [nq, B, Hkv, rep, bq, D] -> [B, S, Hq, D]
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, Hq, D)
