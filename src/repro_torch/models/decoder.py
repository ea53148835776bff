"""Decoder-only LM stack, the dense and ssm families (the port's side of
``repro/models/decoder.py``).

The reference stacks each layer's params along a leading axis and drives
the stack with ``lax.scan``; here the same stacked tree (``layers/slot_0/
{norm1,attn,norm2,ffn}`` for dense, ``layers/slot_0/{norm1,mamba}`` for
ssm, leaves ``[L, ...]``) is walked by a Python loop over that axis. The
cache keeps the reference's layout: ``{"layers": {"slot_0": {"k", "v":
[L, B, cap, Hkv, dh]}}, "length": [B] int32}`` for dense, ``{"conv": [L,
B, W-1, conv_dim]`` in the model's dtype, ``"ssm": [L, B, H, P, N]`` f32}
for ssm. A decode step writes into the cache tensors in place (its KV
row; for ssm, each layer's conv and ssm states, computed anew by
``ssm_decode`` and copied back) and returns the same tensors with
``length + 1``; the reference returns a new cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.attention import (
    attention_decode, attention_full, attention_init, attention_specs)
from repro_torch.models.common import embed_init, rms_norm
from repro_torch.models.mlp import swiglu, swiglu_init, swiglu_shapes
from repro_torch.models.ssm import (
    _dims, ssm_decode, ssm_full, ssm_init, ssm_specs)
from repro_torch.utils import tree_map


def decoder_specs(cfg, dtype) -> Dict[str, Any]:
    """The reference's param tree as ``{name: (shape, dtype)}`` leaves:
    layer leaves carry the leading ``[L]`` axis; RMSNorm scales (and the
    mamba block's ``dt_bias``, ``A_log``, ``D``) are f32."""
    L, D = cfg.num_layers, cfg.d_model

    def stacked(spec):
        if isinstance(spec, dict):
            return {k: stacked(s) for k, s in spec.items()}
        return ((L,) + spec[0], spec[1])

    if cfg.is_attention_free:
        slot = {"norm1": {"scale": ((D,), torch.float32)},
                "mamba": ssm_specs(cfg, dtype)}
    else:
        slot = {"norm1": {"scale": ((D,), torch.float32)},
                "attn": attention_specs(cfg, dtype),
                "norm2": {"scale": ((D,), torch.float32)},
                "ffn": {k: (s, dtype)
                        for k, s in swiglu_shapes(D, cfg.d_ff).items()}}
    p: Dict[str, Any] = {"embed": ((cfg.vocab_size, D), dtype),
                         "layers": {"slot_0": stacked(slot)},
                         "final_norm": {"scale": ((D,), torch.float32)}}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((D, cfg.vocab_size), dtype)
    return p


def slot_init(gen: torch.Generator, cfg, dtype, lead=()) -> Dict[str, Any]:
    """One layer's params (``lead`` prepends stacked axes): RMSNorm
    scales one in f32, attention and SwiGLU weights fan-in truncated
    normal, biases zero; an ssm layer is ``{norm1, mamba}``."""
    def norm():
        return {"scale": torch.ones(lead + (cfg.d_model,),
                                    dtype=torch.float32, device=gen.device)}
    if cfg.is_attention_free:
        return {"norm1": norm(), "mamba": ssm_init(gen, cfg, dtype, lead)}
    return {"norm1": norm(), "attn": attention_init(gen, cfg, dtype, lead),
            "norm2": norm(),
            "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, lead)}


def init_decoder(cfg, gen: torch.Generator, dtype) -> Dict[str, Any]:
    """Fresh params on ``gen``'s device: the layers drawn stacked
    ``[L, ...]`` in one :func:`slot_init`, embeddings N(0, 0.02^2)."""
    D = cfg.d_model
    p: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, D), dtype),
        "layers": {"slot_0": slot_init(gen, cfg, dtype,
                                       lead=(cfg.num_layers,))},
        "final_norm": {"scale": torch.ones((D,), dtype=torch.float32,
                                           device=gen.device)},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (D, cfg.vocab_size), dtype)
    return p


def layer_params(p, layer: int):
    """Layer ``layer``'s slice of the stacked ``layers.slot_0`` params."""
    return tree_map(lambda a: a[layer], p["layers"]["slot_0"])


def slot_apply_full(p, cfg, x, positions, *, sliding_window,
                    want_cache: bool, differentiable: bool = False):
    """Full-sequence layer, its attention or scan the kernel op or, with
    ``differentiable``, its twin. Returns (x, cache_slice)."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    cache = {}
    if not cfg.is_attention_free:
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
    if not cfg.is_attention_free:
        x = x + swiglu(p["ffn"], rms_norm(p["norm2"], x, cfg.norm_eps))
    return x, cache


def slot_apply_decode(p, cfg, x, positions, cache, *, sliding_window):
    """Single-token layer step. Returns (x, cache_slice): the KV slices
    written in place, or the new conv and ssm states."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    if not cfg.is_attention_free:
        y, (k, v) = attention_decode(p["attn"], cfg, h, positions,
                                     cache["k"], cache["v"], positions + 1,
                                     sliding_window=sliding_window)
        new_cache = {"k": k, "v": v}
    else:
        y, (conv_s, ssm_s) = ssm_decode(p["mamba"], cfg, h, cache["conv"],
                                        cache["ssm"])
        new_cache = {"conv": conv_s, "ssm": ssm_s}
    x = x + y
    if not cfg.is_attention_free:
        x = x + swiglu(p["ffn"], rms_norm(p["norm2"], x, cfg.norm_eps))
    return x, new_cache


def _logits(p, cfg, x):
    x = rms_norm(p["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["lm_head"]


def _embed_inputs(p, tokens):
    return p["embed"][tokens.long()]


def decoder_forward(p, cfg, tokens, *, want_cache: bool = False,
                    cache_len: int = 0, sliding_window: Optional[int] = None,
                    differentiable: bool = False
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence forward (train / prefill). tokens [B,S] -> (logits
    [B,S,V], cache or None). ``cache_len`` pads the KV cache up to a
    serving capacity >= S; an attention-free stack ignores it, as the
    reference does. Each layer's attention or scan is the kernel op or,
    with ``differentiable``, its differentiable twin."""
    x = _embed_inputs(p, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    cache = None
    if want_cache:
        cache = make_empty_cache(cfg, B, max(cache_len, S), x.dtype,
                                 length=S, device=x.device)
        layers = cache["layers"]["slot_0"]
    for layer in range(cfg.num_layers):
        x, c = slot_apply_full(layer_params(p, layer), cfg, x, positions,
                               sliding_window=sliding_window,
                               want_cache=want_cache,
                               differentiable=differentiable)
        if want_cache:
            # k, v fill their first S rows; conv, ssm the whole slice
            for name, val in c.items():
                layers[name][layer, :, :val.shape[1]] = val
    return _logits(p, cfg, x), cache


def decoder_decode_step(p, cfg, cache, tokens, *,
                        sliding_window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. tokens [B,1]; cache from :func:`decoder_forward`
    or :func:`make_empty_cache`, written in place (the KV row at
    ``length``, or each layer's new conv and ssm states copied back into
    its slice). Returns (logits
    [B,1,V], the cache with ``length + 1``)."""
    positions = cache["length"]                      # [B], next position
    x = _embed_inputs(p, tokens)
    layers = cache["layers"]["slot_0"]
    for layer in range(cfg.num_layers):
        x, new = slot_apply_decode(
            layer_params(p, layer), cfg, x, positions,
            {name: t[layer] for name, t in layers.items()},
            sliding_window=sliding_window)
        if cfg.is_attention_free:
            for name, val in new.items():
                layers[name][layer].copy_(val)
    return _logits(p, cfg, x), {"layers": cache["layers"],
                                "length": cache["length"] + 1}


def make_empty_cache(cfg, batch: int, capacity: int, dtype,
                     length: Optional[int] = None, device=None) -> Dict:
    """Zeroed cache of ``capacity`` rows a sequence (the ssm states take
    no capacity), ``length`` (default 0) rows marked filled."""
    L = cfg.num_layers
    if cfg.is_attention_free:
        _, H, P, _, N, conv_dim = _dims(cfg)
        slot = {"conv": torch.zeros((L, batch, cfg.ssm_conv_width - 1,
                                     conv_dim), dtype=dtype, device=device),
                "ssm": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                                   device=device)}
    else:
        shape = (L, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
        slot = {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"layers": {"slot_0": slot},
            "length": torch.full((batch,), length or 0, dtype=torch.int32,
                                 device=device)}
