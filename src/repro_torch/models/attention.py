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
reference does. The ``shard_hint`` tags are the reference's: no-ops
outside the dry-run's ``logical_rules``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention, merge_partials)
from repro_torch.kernels.flash_attention import (
    blockwise_attention, flash_attention)
from repro_torch.models.common import dense_init, rms_norm, rope
from repro_torch.sharding import (
    is_sharded, per_device, shard_hint, sharded_reshape)


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
    q = sharded_reshape(q, (B, S, Hq, dh))
    k = sharded_reshape(k, (B, S, Hkv, dh))
    v = sharded_reshape(v, (B, S, Hkv, dh))
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard_hint(q, ("batch", "seq", "heads", None))
    k = shard_hint(k, ("batch", "seq", "kv_heads", None))
    v = shard_hint(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def _attend(attend, q, k, v, **kw):
    """``attend(q, k, v)``; on the dry-run's DTensors, device by device
    over the batch and the heads (``per_device``)."""
    return per_device(attend, [(q, 0, 2), (k, 0, 2), (v, 0, 2)],
                      [(0, 2)], **kw)


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
    o = _attend(attend, q, k, v, causal=causal,
                sliding_window=sliding_window)
    o = shard_hint(o, ("batch", "seq", "heads", None))
    y = shard_hint(o.reshape(B, S, -1) @ p["wo"], ("batch", "seq", "embed"))
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
    q = sharded_reshape(q, (B, S, cfg.num_heads, cfg.head_dim))
    k, v = memory_kv
    attend = blockwise_attention if differentiable else flash_attention
    o = _attend(attend, q, k, v, causal=False)
    return shard_hint(o.reshape(B, S, -1) @ p["wo"], ("batch", "seq", "embed"))


def encode_memory_kv(p, cfg, memory: torch.Tensor):
    """Project the encoder's output [B,T,D] once into cross-attention
    (k, v), each [B,T,Hkv,dh] and contiguous, as the kernels take them."""
    B, T, _ = memory.shape
    k = memory @ p["wk"]
    v = memory @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    shape = (B, T, cfg.num_kv_heads, cfg.head_dim)
    return sharded_reshape(k, shape), sharded_reshape(v, shape)


def _cache_write_dus(cache: torch.Tensor, new: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Write ``new [B,1,Hkv,dh]`` into ``cache [B,T,Hkv,dh]`` at row
    ``positions[b]`` of each sequence, in place (the reference's
    functional ``dynamic_update_slice`` returns a new cache; this one
    writes one row a sequence into the caller's). The start index is
    clamped into the cache as ``dynamic_update_slice`` clamps it: a
    position >= T writes row T-1, a negative one row 0."""
    if is_sharded(cache):
        return _cache_write_sharded(cache, new, positions)
    rows = positions.long().clamp(0, cache.shape[1] - 1)
    batch = torch.arange(cache.shape[0], device=cache.device)
    cache[batch, rows] = new[:, 0].to(cache.dtype)
    return cache


def _cache_write_sharded(cache, new: torch.Tensor,
                         positions: torch.Tensor):
    """The in-place row write of :func:`_cache_write_dus` on a DTensor
    cache (the dry-run), device by device: ``new`` and ``positions`` are
    brought to the cache's batch sharding, and each device writes, into
    its own rows of the cache, the sequences whose position falls there
    (a row of its shard is rewritten with itself otherwise). DTensor has
    no in-place scatter into a sharded dimension."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    keep = [pl if pl == Shard(0) else Replicate() for pl in cache.placements]
    new = new.redistribute(mesh, keep)._local_tensor
    positions = positions.redistribute(mesh, keep)._local_tensor
    local = cache._local_tensor
    rows_here = local.shape[1]
    offset = 0
    for m, pl in enumerate(cache.placements):    # mesh dims in major order
        if pl == Shard(1):
            offset = offset * mesh.size(m) + mesh.get_local_rank(m)
    rows = positions.long() - offset * rows_here
    here = (rows >= 0) & (rows < rows_here)
    rows = rows.clamp(0, rows_here - 1)
    batch = torch.arange(local.shape[0], device=local.device)
    local[batch, rows] = torch.where(here[:, None, None],
                                     new[:, 0].to(local.dtype),
                                     local[batch, rows])
    return cache


def _decode_partial(q, k, v, lengths, offset: int, window):
    """One shard's partial decode attention over its cache rows (global
    rows ``offset`` on): (out [B,Hq,D] f32, lse [B,Hq], -inf where the
    shard holds no valid key of a sequence)."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    kr = k.float().repeat_interleave(rep, dim=2)
    vr = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kr) * D ** -0.5
    t = torch.arange(T, device=q.device)[None, :] + offset
    lengths = lengths.long()[:, None]
    valid = t < lengths
    if window is not None:
        valid &= t >= lengths - window
    s = torch.where(valid[:, None, :], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid[:, None, :]
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bht,bthd->bhd", p / l.clamp(min=1e-30), vr)
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-30)), -torch.inf)
    return out, lse[..., 0]


def _decode_attention_sharded(q, kcache, vcache, lengths, *, window=None):
    """``decode_attention`` on a DTensor cache whose rows (``kv_seq``)
    are sharded (the dry-run): each device attends its own rows
    (:func:`_decode_partial`), the partial outputs and log-sum-exps are
    gathered over the mesh axes that shard the rows, and merged
    (``merge_partials``), the flash-decoding split the reference's
    partitioner makes of its softmax. Returns (out, lse) as DTensors
    sharded over the batch as the cache is."""
    from torch.distributed._functional_collectives import all_gather_tensor
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = kcache.device_mesh
    keep = [pl if pl == Shard(0) else Replicate() for pl in kcache.placements]
    ql = q.redistribute(mesh, keep)._local_tensor
    ll = lengths.redistribute(mesh, keep)._local_tensor
    kl, vl = kcache._local_tensor, vcache.redistribute(
        mesh, kcache.placements)._local_tensor
    rows = [m for m, pl in enumerate(kcache.placements) if pl == Shard(1)]
    offset = 0
    for m in rows:
        offset = offset * mesh.size(m) + mesh.get_local_rank(m)
    out, lse = _decode_partial(ql, kl, vl, ll, offset * kl.shape[1], window)
    outs, lses = out[None], lse[None]
    for m in reversed(rows):    # minor mesh dims first, so the shards stack
        outs = all_gather_tensor(outs, 0, (mesh, m))   # in row order
        lses = all_gather_tensor(lses, 0, (mesh, m))
    out = merge_partials(outs, lses).to(q.dtype)
    lse = torch.logsumexp(lses, dim=0)
    wrap = functools.partial(DTensor.from_local, device_mesh=mesh,
                             placements=keep, run_check=False)
    return wrap(out), wrap(lse)


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
    kcache = shard_hint(kcache, ("batch", "kv_seq", "kv_heads", None))
    vcache = shard_hint(vcache, ("batch", "kv_seq", "kv_heads", None))
    attend = (_decode_attention_sharded if is_sharded(kcache)
              else decode_attention)
    out, _lse = attend(q[:, 0], kcache, vcache, positions + 1,
                       window=sliding_window)
    y = out.reshape(B, 1, -1) @ p["wo"]
    return shard_hint(y, ("batch", "seq", "embed")), (kcache, vcache)
