"""GQA attention block, full-sequence and single-token decode paths (the
port's side of ``repro/models/attention.py``).

Params keep the reference's tree and layouts: ``wq [D, Hq*dh]``, ``wk``,
``wv [D, Hkv*dh]``, ``wo [Hq*dh, D]``, optional biases ``bq``, ``bk``,
``bv`` and f32 ``q_norm`` / ``k_norm`` scales. The projections are plain
``torch.matmul``; the attention itself goes through the kernel ops
(``flash_attention`` for a sequence, ``decode_attention`` for one token),
or, for a sequence, through the differentiable ``blockwise_attention``
that local training takes (``differentiable``). RoPE is applied unless
``use_rope`` is off (whisper's encoder and decoder). Cross-attention
(whisper's decoder) projects q alone and attends the encoder's K/V,
projected once by :func:`encode_memory_kv`, through ``flash_attention``
non-causal, in a prefill and in every decode step alike, as the
reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (
    blockwise_attention, flash_attention)
from repro_torch.models.common import dense_init, rms_norm, rope


def attention_specs(cfg, dtype) -> Dict:
    """Leaf shapes and dtypes of one attention block: ``{name: (shape,
    dtype)}``; the qk-norm scales stay f32."""
    D, Hq, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Dict = {"wq": ((D, Hq * dh), dtype), "wk": ((D, Hkv * dh), dtype),
               "wv": ((D, Hkv * dh), dtype), "wo": ((Hq * dh, D), dtype)}
    if cfg.qkv_bias:
        p.update(bq=((Hq * dh,), dtype), bk=((Hkv * dh,), dtype),
                 bv=((Hkv * dh,), dtype))
    if cfg.qk_norm:
        p["q_norm"] = {"scale": ((dh,), torch.float32)}
        p["k_norm"] = {"scale": ((dh,), torch.float32)}
    return p


def attention_init(gen: torch.Generator, cfg, dtype, lead=()) -> Dict:
    """Fresh params drawn on ``gen``'s device; ``lead`` prepends stacked
    axes (the decoder's layer axis): weights fan-in truncated normal,
    biases zero, norm scales one."""
    def leaf(name, spec):
        if isinstance(spec, dict):
            return {k: leaf(k, s) for k, s in spec.items()}
        shape, dt = spec
        if name == "scale":
            return torch.ones(lead + shape, dtype=dt, device=gen.device)
        if name.startswith("b"):
            return torch.zeros(lead + shape, dtype=dt, device=gen.device)
        return dense_init(gen, lead + shape, in_axis=len(lead), dtype=dt)
    return {k: leaf(k, s) for k, s in attention_specs(cfg, dtype).items()}


def _project_qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                 use_rope: bool = True):
    B, S, _ = x.shape
    Hq, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, Hq, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_full(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                   causal: bool = True, sliding_window: Optional[int] = None,
                   use_rope: bool = True, return_kv: bool = False,
                   differentiable: bool = False):
    """Full-sequence path (training / prefill). x [B,S,D] -> y [B,S,D];
    with ``return_kv`` also the (roped unless ``use_rope`` is off) (k, v)
    [B,S,Hkv,dh] for the cache. The attention is ``flash_attention`` or,
    with ``differentiable``, ``blockwise_attention``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, use_rope)
    attend = blockwise_attention if differentiable else flash_attention
    o = attend(q, k, v, causal=causal, sliding_window=sliding_window)
    y = o.reshape(B, S, -1) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def cross_attention_full(p, cfg, x: torch.Tensor, memory_kv, *,
                         differentiable: bool = False) -> torch.Tensor:
    """Decoder cross-attention against the encoder's K/V ``memory_kv``
    (each [B,T,Hkv,dh]): x [B,S,D] -> y [B,S,D]. q alone is projected
    (``bq`` added with ``qkv_bias``) and attends every memory row,
    non-causal, through ``flash_attention`` (``blockwise_attention`` with
    ``differentiable``), whatever S, a decode step's S = 1 included."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k, v = memory_kv
    attend = blockwise_attention if differentiable else flash_attention
    o = attend(q, k, v, causal=False)
    return o.reshape(B, S, -1) @ p["wo"]


def encode_memory_kv(p, cfg, memory: torch.Tensor):
    """Project the encoder's output [B,T,D] once into cross-attention
    (k, v), each [B,T,Hkv,dh] and contiguous, as the kernels take them."""
    B, T, _ = memory.shape
    k = memory @ p["wk"]
    v = memory @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    shape = (B, T, cfg.num_kv_heads, cfg.head_dim)
    return k.reshape(shape), v.reshape(shape)


def _cache_write_dus(cache: torch.Tensor, new: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Write ``new [B,1,Hkv,dh]`` into ``cache [B,T,Hkv,dh]`` at row
    ``positions[b]`` of each sequence, in place (the reference's
    functional ``dynamic_update_slice`` returns a new cache; this one
    writes one row a sequence into the caller's). The start index is
    clamped into the cache as ``dynamic_update_slice`` clamps it: a
    position >= T writes row T-1, a negative one row 0."""
    rows = positions.long().clamp(0, cache.shape[1] - 1)
    batch = torch.arange(cache.shape[0], device=cache.device)
    cache[batch, rows] = new[:, 0].to(cache.dtype)
    return cache


def attention_decode(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                     kcache: torch.Tensor, vcache: torch.Tensor,
                     lengths: torch.Tensor, *,
                     sliding_window: Optional[int] = None,
                     use_rope: bool = True
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Single-token decode. x [B,1,D]; caches [B,T,Hkv,dh]; positions [B]
    int32. Writes the new K/V at ``positions`` (in place), then attends
    the first ``positions + 1`` entries through ``decode_attention``, as
    the reference does (its ``lengths`` argument is not read there
    either)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, positions[:, None], use_rope)
    kcache = _cache_write_dus(kcache, k, positions)
    vcache = _cache_write_dus(vcache, v, positions)
    out, _lse = decode_attention(q[:, 0], kcache, vcache, positions + 1,
                                 window=sliding_window)
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, (kcache, vcache)
