"""Decoder-only LM stack, the dense, moe, ssm, hybrid and vlm families
(the port's side of ``repro/models/decoder.py``).

The reference stacks the layers' params along a leading axis and drives
the stack with ``lax.scan``; the hybrid (Jamba) family scans over
*periods* of layers (:func:`_period`: attention where ``layer_idx %
attn_every == attn_offset``, MoE where ``layer_idx % moe_every ==
moe_offset``), each period an unrolled run of slots whose params are
stacked across periods. The port keeps that tree, ``layers/slot_0 ..
slot_{period-1}``, each leaf ``[num_layers // period, ...]``, and walks it
with a Python loop: period p, slot s is layer ``p * period + s``. A slot
is ``{norm1, attn | mamba}`` and, outside the ssm family, ``{norm2, moe |
ffn}``; dense, moe and ssm are one slot. The full-sequence forward
returns the MoE load-balance loss summed over the layers. A vlm's
stub patch embeddings (``prefix_embeds`` ``[B, P, D]``) go through its
``patch_proj [D, D]`` and sit before the text: positions, logits and
the cache's ``length`` count them.

The cache keeps the reference's layout, slot by slot: ``{"layers":
{"slot_s": {"k", "v": [P, B, cap, Hkv, dh]}}, "length": [B] int32}`` for
an attention slot, ``{"conv": [P, B, W-1, conv_dim]`` in the model's
dtype, ``"ssm": [P, B, H, P_head, N]`` f32} for a mamba slot. A decode
step writes into the cache tensors in place (its KV row; each mamba
layer's conv and ssm states, computed anew by ``ssm_decode`` and copied
back) and returns the same tensors with ``length + 1``; the reference
returns a new cache. Prefill routes the MoE by capacity unless asked for
``moe_dropless``; decode is always dropless, as in the reference. With
``remat`` the full-sequence forward runs each layer under
``torch.utils.checkpoint`` (one layer a checkpoint, its activations
recomputed in the backward), the twin of the reference's checkpointed
scan body.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    attention_decode, attention_full, attention_init, attention_specs)
from repro_torch.models.common import embed_init, rms_norm
from repro_torch.models.mlp import swiglu, swiglu_init, swiglu_shapes
from repro_torch.models.moe import moe_apply, moe_init, moe_specs
from repro_torch.models.ssm import (
    _dims, ssm_decode, ssm_full, ssm_init, ssm_specs)
from repro_torch.sharding import full_hint, per_device, shard_hint
from repro_torch.utils import tree_map


def _period(cfg) -> int:
    """Layers a period: 1 for the homogeneous stacks, ``attn_every`` (or
    its common multiple with ``moe_every``) for hybrid."""
    if cfg.family == "hybrid":
        p = cfg.attn_every
        if cfg.has_moe:
            p = max(p, cfg.moe_every) if p % cfg.moe_every == 0 else \
                p * cfg.moe_every
        return p
    return 1


def _periods(cfg) -> Tuple[int, int]:
    """(layers a period, periods)."""
    period = _period(cfg)
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"whole number of periods of {period}")
    return period, cfg.num_layers // period


def slot_specs(cfg, layer_idx: int, dtype) -> Dict[str, Any]:
    """Leaf shapes and dtypes of layer ``layer_idx``: ``{name: (shape,
    dtype)}``. RMSNorm scales, the router and the mamba block's
    ``dt_bias``, ``A_log``, ``D`` are f32."""
    D = cfg.d_model
    norm = {"scale": ((D,), torch.float32)}
    p: Dict[str, Any] = {"norm1": norm}
    if cfg.uses_attention(layer_idx):
        p["attn"] = attention_specs(cfg, dtype)
    else:
        p["mamba"] = ssm_specs(cfg, dtype)
    if cfg.family != "ssm":
        p["norm2"] = norm
        if cfg.uses_moe(layer_idx):
            p["moe"] = moe_specs(cfg, dtype)
        else:
            p["ffn"] = {k: (s, dtype)
                        for k, s in swiglu_shapes(D, cfg.d_ff).items()}
    return p


def decoder_specs(cfg, dtype) -> Dict[str, Any]:
    """The reference's param tree as ``{name: (shape, dtype)}`` leaves:
    slot leaves carry the leading ``[periods]`` axis."""
    period, n_periods = _periods(cfg)
    D = cfg.d_model

    def stacked(spec):
        if isinstance(spec, dict):
            return {k: stacked(s) for k, s in spec.items()}
        return ((n_periods,) + spec[0], spec[1])

    p: Dict[str, Any] = {
        "embed": ((cfg.vocab_size, D), dtype),
        "layers": {f"slot_{s}": stacked(slot_specs(cfg, s, dtype))
                   for s in range(period)},
        "final_norm": {"scale": ((D,), torch.float32)}}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((D, cfg.vocab_size), dtype)
    if cfg.family == "vlm":
        p["patch_proj"] = ((D, D), dtype)
    return p


def slot_init(gen: torch.Generator, cfg, layer_idx: int, dtype, lead=()
              ) -> Dict[str, Any]:
    """Layer ``layer_idx``'s params (``lead`` prepends stacked axes):
    RMSNorm scales one in f32, the attention or mamba block, then the MoE
    or SwiGLU FFN, each drawn by its own init."""
    def norm():
        return {"scale": torch.ones(lead + (cfg.d_model,),
                                    dtype=torch.float32, device=gen.device)}
    p: Dict[str, Any] = {"norm1": norm()}
    if cfg.uses_attention(layer_idx):
        p["attn"] = attention_init(gen, cfg, dtype, lead)
    else:
        p["mamba"] = ssm_init(gen, cfg, dtype, lead)
    if cfg.family != "ssm":
        p["norm2"] = norm()
        if cfg.uses_moe(layer_idx):
            p["moe"] = moe_init(gen, cfg, dtype, lead)
        else:
            p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, lead)
    return p


def init_decoder(cfg, gen: torch.Generator, dtype) -> Dict[str, Any]:
    """Fresh params on ``gen``'s device: the embedding N(0, 0.02^2), each
    slot's layers drawn stacked ``[periods, ...]`` in one
    :func:`slot_init`, then the LM head when untied and a vlm's
    ``patch_proj``, both N(0, 0.02^2)."""
    period, n_periods = _periods(cfg)
    D = cfg.d_model
    p: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, D), dtype),
        "layers": {f"slot_{s}": slot_init(gen, cfg, s, dtype,
                                          lead=(n_periods,))
                   for s in range(period)},
        "final_norm": {"scale": torch.ones((D,), dtype=torch.float32,
                                           device=gen.device)},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (D, cfg.vocab_size), dtype)
    if cfg.family == "vlm":
        p["patch_proj"] = embed_init(gen, (D, D), dtype)
    return p


def layer_params(p, period: int, slot: int = 0):
    """Period ``period``'s slice of ``layers.slot_{slot}``."""
    return tree_map(lambda a: a[period], p["layers"][f"slot_{slot}"])


def unbound_layers(stack):
    """A stacked layer tree ``{name: [L, ...]}`` as one tree of
    L-tuples of views, for a pass that takes every layer: its backward
    stacks the L grads once, where a slice a layer (``a[i]``) would fill a
    zeroed ``[L, ...]`` grad for each layer (O(L^2) bytes)."""
    return tree_map(lambda a: a.unbind(0), stack)


def _ffn(p, cfg, x, *, moe_dropless: bool, moe_group_size: int):
    """The second half of a non-ssm layer: x + (MoE or SwiGLU) of its
    RMSNorm. Returns (x, aux)."""
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_apply(p["moe"], cfg, h, dropless=moe_dropless,
                           group_size=moe_group_size)
        return x + y, aux
    return x + swiglu(p["ffn"], h), None


def slot_apply_full(p, cfg, x, positions, *, sliding_window,
                    want_cache: bool, differentiable: bool = False,
                    moe_dropless: bool = False, moe_group_size: int = 0):
    """Full-sequence layer, its attention or scan the kernel op or, with
    ``differentiable``, its twin. Returns (x, cache_slice, aux): aux the
    MoE's load-balance loss, None for a layer without one."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    cache = {}
    if "attn" in p:
        if want_cache:
            y, (k, v) = attention_full(p["attn"], cfg, h, positions,
                                       causal=True,
                                       sliding_window=sliding_window,
                                       return_kv=True,
                                       differentiable=differentiable)
            cache = {"k": k, "v": v}
        else:
            y = attention_full(p["attn"], cfg, h, positions, causal=True,
                               sliding_window=sliding_window,
                               differentiable=differentiable)
    elif want_cache:
        y, (conv_s, ssm_s) = ssm_full(p["mamba"], cfg, h, return_state=True,
                                      differentiable=differentiable)
        cache = {"conv": conv_s, "ssm": ssm_s}
    else:
        y = ssm_full(p["mamba"], cfg, h, differentiable=differentiable)
    x = x + y
    aux = None
    if "norm2" in p:
        x, aux = _ffn(p, cfg, x, moe_dropless=moe_dropless,
                      moe_group_size=moe_group_size)
    return x, cache, aux


def slot_apply_decode(p, cfg, x, positions, cache, *, sliding_window):
    """Single-token layer step, its MoE dropless. Returns (x,
    cache_slice): the KV slices written in place, or the new conv and ssm
    states."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    if "attn" in p:
        y, (k, v) = attention_decode(p["attn"], cfg, h, positions,
                                     cache["k"], cache["v"], positions + 1,
                                     sliding_window=sliding_window)
        new_cache = {"k": k, "v": v}
    else:
        y, (conv_s, ssm_s) = ssm_decode(p["mamba"], cfg, h, cache["conv"],
                                        cache["ssm"])
        new_cache = {"conv": conv_s, "ssm": ssm_s}
    x = x + y
    if "norm2" in p:
        x, _ = _ffn(p, cfg, x, moe_dropless=True, moe_group_size=0)
    return x, new_cache


def lm_head(p, cfg) -> torch.Tensor:
    """The ``[D, V]`` output projection (the embedding's transpose when
    tied)."""
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def _logits(p, cfg, x):
    x = rms_norm(p["final_norm"], x, cfg.norm_eps)
    return shard_hint(x @ lm_head(p, cfg), ("batch", "seq", "vocab"))


def _lookup(ids, table):
    return table[ids.long()]


def embed_lookup(table, ids):
    """``table[ids]``; on the dry-run's DTensors, device by device: each
    looks its own tokens up in the gathered table (DTensor's index
    strategies do not take ids sharded over two mesh axes)."""
    return per_device(_lookup, [(ids, 0, None), (table, None, None)],
                      [(0, None)])


def _embed_inputs(p, cfg, tokens, prefix_embeds=None):
    """Token embeddings [B,S,D], after ``prefix_embeds`` [B,P,D] when
    given: cast to the embeddings' dtype and, for a vlm, projected by
    ``patch_proj``."""
    x = embed_lookup(p["embed"], tokens)
    if prefix_embeds is not None:
        pe = prefix_embeds.to(x.dtype)
        if cfg.family == "vlm":
            pe = pe @ p["patch_proj"]
        x = torch.cat([pe, x], dim=1)
    return shard_hint(x, ("batch", "seq", "embed"))


def decoder_forward(p, cfg, tokens, *, prefix_embeds=None,
                    want_cache: bool = False,
                    cache_len: int = 0, sliding_window: Optional[int] = None,
                    differentiable: bool = False, moe_dropless: bool = False,
                    moe_group_size: int = 0, remat: bool = False,
                    return_hidden: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Full-sequence forward (train / prefill). tokens [B,S], after
    ``prefix_embeds`` [B,P,D] where given (a vlm's patches) -> (logits
    [B,P+S,V], the MoE aux loss summed over the layers (an f32 scalar, 0
    without MoE), cache or None). ``cache_len`` pads the KV cache up to a
    serving capacity >= S; a stack without attention ignores it, as the
    reference does. Each layer's attention or scan is the kernel op or,
    with ``differentiable``, its differentiable twin; the MoE routes by
    capacity over groups of ``moe_group_size`` or, with
    ``moe_dropless``, dropless. ``remat`` checkpoints each layer (not with
    ``want_cache``); ``return_hidden`` returns the final-normed hidden
    states [B,P+S,D] in place of the logits."""
    x = _embed_inputs(p, cfg, tokens, prefix_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    period, n_periods = _periods(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if want_cache:
        cache = make_empty_cache(cfg, B, max(cache_len, S), x.dtype,
                                 length=S, device=x.device, like=x)
    if remat and want_cache:
        raise ValueError("remat is for training: it takes no cache")
    layer = functools.partial(
        slot_apply_full, cfg=cfg, positions=positions,
        sliding_window=sliding_window, want_cache=want_cache,
        differentiable=differentiable, moe_dropless=moe_dropless,
        moe_group_size=moe_group_size)
    slots = [unbound_layers(p["layers"][f"slot_{s}"]) for s in range(period)]
    for i in range(n_periods):
        for s in range(period):
            lp = tree_map(lambda views: views[i], slots[s])
            if remat:
                x, c, a = checkpoint(layer, lp, x=x, use_reentrant=False)
            else:
                x, c, a = layer(lp, x=x)
            if a is not None:
                aux = aux + a
            if want_cache:
                # k, v fill their first S rows; conv, ssm the whole slice
                slot = cache["layers"][f"slot_{s}"]
                for name, val in c.items():
                    slot[name][i, :, :val.shape[1]] = val
    if return_hidden:
        return rms_norm(p["final_norm"], x, cfg.norm_eps), aux, None
    return _logits(p, cfg, x), aux, cache


def decoder_decode_step(p, cfg, cache, tokens, *,
                        sliding_window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. tokens [B,1]; cache from :func:`decoder_forward`
    or :func:`make_empty_cache`, written in place (the KV row at
    ``length``, or each mamba layer's new conv and ssm states copied back
    into its slice). Returns (logits [B,1,V], the cache with ``length +
    1``)."""
    positions = cache["length"]                      # [B], next position
    x = _embed_inputs(p, cfg, tokens)
    period, n_periods = _periods(cfg)
    for i in range(n_periods):
        for s in range(period):
            slot = cache["layers"][f"slot_{s}"]
            x, new = slot_apply_decode(
                layer_params(p, i, s), cfg, x, positions,
                {name: t[i] for name, t in slot.items()},
                sliding_window=sliding_window)
            if "ssm" in new:
                for name, val in new.items():
                    slot[name][i].copy_(val)
    return _logits(p, cfg, x), {"layers": cache["layers"],
                                "length": cache["length"] + 1}


def make_empty_cache(cfg, batch: int, capacity: int, dtype,
                     length: Optional[int] = None, device=None,
                     like=None) -> Dict:
    """Zeroed cache of ``capacity`` rows a sequence for each attention
    slot (a mamba slot's states take no capacity), ``length`` (default
    0) rows marked filled. Where ``like`` is a DTensor under the dry-run's
    rules, the cache is made sharded as the rules lay it out."""
    period, n_periods = _periods(cfg)

    def zeros(shape, axes, dt=dtype):
        return full_hint(shape, 0, axes, dtype=dt, device=device, like=like)

    kv_axes = (None, "batch", "kv_seq", "kv_heads", None)
    layers = {}
    for s in range(period):
        if cfg.uses_attention(s):
            shape = (n_periods, batch, capacity, cfg.num_kv_heads,
                     cfg.head_dim)
            layers[f"slot_{s}"] = {"k": zeros(shape, kv_axes),
                                   "v": zeros(shape, kv_axes)}
        else:
            _, H, P, _, N, conv_dim = _dims(cfg)
            layers[f"slot_{s}"] = {
                "conv": zeros((n_periods, batch, cfg.ssm_conv_width - 1,
                               conv_dim), (None, "batch", None, "mlp")),
                "ssm": zeros((n_periods, batch, H, P, N),
                             (None, "batch", "heads", None, None),
                             torch.float32)}
    return {"layers": layers,
            "length": full_hint((batch,), length or 0, ("batch",),
                                dtype=torch.int32, device=device,
                                like=like)}
