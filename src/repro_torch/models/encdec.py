"""Whisper-style encoder-decoder, the ``encdec`` family (the port's side of
``repro/models/encdec.py``; the audio frontend is a stub, see
``frontend_stub``).

Encoder: bidirectional attention over precomputed frame embeddings plus
sinusoidal positions. Decoder: causal self-attention, cross-attention to
the encoder's output and a GELU MLP, over learned absolute positions
(``dec_pos``). LayerNorm throughout, pre-norm residuals, tied embeddings
(the logits are ``x @ embed.T``), no RoPE anywhere. Every attention goes
through ``flash_attention`` (``blockwise_attention`` under
``differentiable``): the encoder's non-causal, the decoder's causal
self-attention in a prefill, and its cross-attention non-causal in a
prefill and in every decode step, as the reference runs it; a decode
step's self-attention goes through ``decode_attention``.

The tree is the reference's: ``embed``, ``dec_pos`` (``max(
decoder_max_position, max_target_positions)`` rows), ``encoder`` and
``decoder`` with their layers stacked ``[L, ...]``, ``enc_final_norm``
and ``dec_final_norm``; the LayerNorm scales and biases stay f32. The
cache keeps the reference's layout, ``{"self": {"k", "v": [L, B, cap,
Hkv, dh]}, "cross": {"k", "v": [L, B, T_enc, Hkv, dh]}, "length": [B]
int32}``; a decode step writes its self-attention K/V row in place and
returns the same tensors with ``length + 1`` (the reference returns a
new cache).

Where the reference's gather into ``dec_pos`` clamps a position past the
table (JAX clamps out-of-range indices), the port raises ``ValueError``
before reading: a prompt longer than the table, or a cache whose rows
the table cannot all place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    attention_decode, attention_full, attention_init, attention_specs,
    cross_attention_full, encode_memory_kv)
from repro_torch.models.common import (
    embed_init, layer_norm, sinusoidal_positions)
from repro_torch.models.decoder import embed_lookup, unbound_layers
from repro_torch.models.mlp import gelu_mlp, gelu_mlp_init, gelu_mlp_specs
from repro_torch.sharding import shard_hint
from repro_torch.utils import tree_map


def _norm_spec(cfg):
    return {"scale": ((cfg.d_model,), torch.float32),
            "bias": ((cfg.d_model,), torch.float32)}


def encdec_specs(cfg, dtype, max_target_positions: int = 0) -> Dict[str, Any]:
    """The reference's param tree as ``{name: (shape, dtype)}`` leaves,
    each layer leaf with its leading ``[L]`` axis."""
    D = cfg.d_model
    attn = attention_specs(cfg, dtype)
    mlp = gelu_mlp_specs(D, cfg.d_ff, dtype)
    norm = _norm_spec(cfg)

    def stacked(spec, n):
        if isinstance(spec, dict):
            return {k: stacked(s, n) for k, s in spec.items()}
        return ((n,) + spec[0], spec[1])

    return {
        "embed": ((cfg.vocab_size, D), dtype),
        "dec_pos": ((max(cfg.decoder_max_position, max_target_positions), D),
                    dtype),
        "encoder": stacked({"norm1": norm, "attn": attn, "norm2": norm,
                            "mlp": mlp}, cfg.encoder_layers),
        "enc_final_norm": norm,
        "decoder": stacked({"norm1": norm, "self_attn": attn, "norm2": norm,
                            "cross_attn": attn, "norm3": norm, "mlp": mlp},
                           cfg.num_layers),
        "dec_final_norm": norm}


def _norm_init(cfg, device, lead=()):
    return {"scale": torch.ones(lead + (cfg.d_model,), dtype=torch.float32,
                                device=device),
            "bias": torch.zeros(lead + (cfg.d_model,), dtype=torch.float32,
                                device=device)}


def init_encdec(cfg, gen: torch.Generator, dtype,
                max_target_positions: int = 0) -> Dict[str, Any]:
    """Fresh params on ``gen``'s device: the embedding and ``dec_pos``
    N(0, 0.02^2), each stack's layers drawn stacked ``[L, ...]``
    (weights fan-in truncated normal, biases zero, norm scales one)."""
    D, dev = cfg.d_model, gen.device
    enc, dec = (cfg.encoder_layers,), (cfg.num_layers,)
    return {
        "embed": embed_init(gen, (cfg.vocab_size, D), dtype),
        "dec_pos": embed_init(gen, (max(cfg.decoder_max_position,
                                        max_target_positions), D), dtype),
        "encoder": {"norm1": _norm_init(cfg, dev, enc),
                    "attn": attention_init(gen, cfg, dtype, enc),
                    "norm2": _norm_init(cfg, dev, enc),
                    "mlp": gelu_mlp_init(gen, D, cfg.d_ff, dtype, enc)},
        "enc_final_norm": _norm_init(cfg, dev),
        "decoder": {"norm1": _norm_init(cfg, dev, dec),
                    "self_attn": attention_init(gen, cfg, dtype, dec),
                    "norm2": _norm_init(cfg, dev, dec),
                    "cross_attn": attention_init(gen, cfg, dtype, dec),
                    "norm3": _norm_init(cfg, dev, dec),
                    "mlp": gelu_mlp_init(gen, D, cfg.d_ff, dtype, dec)},
        "dec_final_norm": _norm_init(cfg, dev)}


def _layer(stack, i: int):
    return tree_map(lambda a: a[i], stack)


def _check_positions(p, rows: int, what: str) -> None:
    """Refuse ``rows`` decoder positions where ``dec_pos`` has fewer."""
    table = p["dec_pos"].shape[0]
    if rows > table:
        raise ValueError(
            f"{what} needs {rows} decoder positions, past the {table}-row "
            f"position table dec_pos (the reference would clamp the "
            f"gather); build the model with max_target_positions >= "
            f"{rows}")


def encode(p, cfg, frames: torch.Tensor, *,
           differentiable: bool = False) -> torch.Tensor:
    """frames [B, T_enc, D] (stub embeddings) -> encoder states [B, T_enc,
    D]: sinusoidal positions added in the frames' dtype, then the layers'
    non-causal attention without RoPE and GELU MLP."""
    B, T, D = frames.shape
    x = shard_hint(frames + sinusoidal_positions(T, D, frames.device
                                                 ).to(frames.dtype)[None],
                   ("batch", "seq", "embed"))
    layers = unbound_layers(p["encoder"])
    for i in range(cfg.encoder_layers):
        lp = tree_map(lambda views: views[i], layers)
        h = layer_norm(lp["norm1"], x, cfg.norm_eps)
        x = x + attention_full(lp["attn"], cfg, h, None, causal=False,
                               use_rope=False, differentiable=differentiable)
        h = layer_norm(lp["norm2"], x, cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], h)
    return layer_norm(p["enc_final_norm"], x, cfg.norm_eps)


def _logits(p, cfg, x):
    return shard_hint(
        layer_norm(p["dec_final_norm"], x, cfg.norm_eps) @ p["embed"].T,
        ("batch", "seq", "vocab"))


def _decoder_layer(lp, cfg, x, enc_states, *, differentiable: bool):
    """One decoder layer of the teacher-forced pass: (x, the self K/V,
    the cross K/V)."""
    h = layer_norm(lp["norm1"], x, cfg.norm_eps)
    out, kv = attention_full(lp["self_attn"], cfg, h, None, causal=True,
                             use_rope=False, return_kv=True,
                             differentiable=differentiable)
    x = x + out
    h = layer_norm(lp["norm2"], x, cfg.norm_eps)
    mem_kv = encode_memory_kv(lp["cross_attn"], cfg, enc_states)
    x = x + cross_attention_full(lp["cross_attn"], cfg, h, mem_kv,
                                 differentiable=differentiable)
    h = layer_norm(lp["norm3"], x, cfg.norm_eps)
    return x + gelu_mlp(lp["mlp"], h), kv, mem_kv


def decode_full(p, cfg, tokens: torch.Tensor, enc_states: torch.Tensor, *,
                want_cache: bool = False, cache_len: int = 0,
                differentiable: bool = False, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Teacher-forced decoder pass (train / prefill). tokens [B,S] at
    positions 0..S-1 -> (logits [B,S,V], a zero f32 aux (no MoE), the
    cache or None). The cache holds ``max(cache_len, S)`` self-attention
    rows a layer, its first S filled, and each layer's cross K/V.
    ``remat`` checkpoints each decoder layer (not with ``want_cache``)."""
    B, S = tokens.shape
    _check_positions(p, max(cache_len, S) if want_cache else S,
                     "the prompt" + (" and its cache" if want_cache else ""))
    if remat and want_cache:
        raise ValueError("remat is for training: it takes no cache")
    x = shard_hint(embed_lookup(p["embed"], tokens) + p["dec_pos"][:S],
                   ("batch", "seq", "embed"))
    T = enc_states.shape[1]
    cache = None
    if want_cache:
        cache = _empty_cache(cfg, B, max(cache_len, S), T, x.dtype, S,
                             x.device)
    layers = unbound_layers(p["decoder"])
    for i in range(cfg.num_layers):
        lp = tree_map(lambda views: views[i], layers)
        if remat:
            x, kv, mem_kv = checkpoint(
                _decoder_layer, lp, cfg, x, enc_states, use_reentrant=False,
                differentiable=differentiable)
        else:
            x, kv, mem_kv = _decoder_layer(lp, cfg, x, enc_states,
                                           differentiable=differentiable)
        if want_cache:
            cache["self"]["k"][i, :, :S] = kv[0]
            cache["self"]["v"][i, :, :S] = kv[1]
            cache["cross"]["k"][i] = mem_kv[0]
            cache["cross"]["v"][i] = mem_kv[1]
    return (_logits(p, cfg, x),
            torch.zeros((), dtype=torch.float32, device=x.device), cache)


def decode_step(p, cfg, cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. tokens [B,1] at positions ``cache["length"]``;
    each layer writes its self-attention K/V row in place, attends it
    through ``decode_attention`` and the cross K/V through
    ``flash_attention`` (S = 1). Returns (logits [B,1,V], the cache with
    ``length + 1``). A cache of more rows than ``dec_pos`` is refused:
    its positions cannot all be placed."""
    _check_positions(p, cache["self"]["k"].shape[2], "the cache")
    positions = cache["length"]
    x = (embed_lookup(p["embed"], tokens)
         + embed_lookup(p["dec_pos"], positions)[:, None])
    for i in range(cfg.num_layers):
        lp = _layer(p["decoder"], i)
        h = layer_norm(lp["norm1"], x, cfg.norm_eps)
        y, _ = attention_decode(lp["self_attn"], cfg, h, positions,
                                cache["self"]["k"][i], cache["self"]["v"][i],
                                positions + 1, use_rope=False)
        x = x + y
        h = layer_norm(lp["norm2"], x, cfg.norm_eps)
        x = x + cross_attention_full(
            lp["cross_attn"], cfg, h,
            (cache["cross"]["k"][i], cache["cross"]["v"][i]))
        h = layer_norm(lp["norm3"], x, cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], h)
    return _logits(p, cfg, x), {"self": cache["self"],
                                "cross": cache["cross"],
                                "length": cache["length"] + 1}


def _empty_cache(cfg, batch, capacity, enc_seq, dtype, length, device):
    L, Hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(rows):
        return torch.zeros((L, batch, rows, Hkv, dh), dtype=dtype,
                           device=device)
    return {"self": {"k": zeros(capacity), "v": zeros(capacity)},
            "cross": {"k": zeros(enc_seq), "v": zeros(enc_seq)},
            "length": torch.full((batch,), length or 0, dtype=torch.int32,
                                 device=device)}


def make_empty_cache(cfg, batch: int, capacity: int, dtype,
                     length: Optional[int] = None, device=None) -> Dict:
    """Zeroed cache: ``capacity`` self-attention rows a layer and
    ``encoder_seq`` cross rows, ``length`` (default 0) rows marked
    filled."""
    return _empty_cache(cfg, batch, capacity, cfg.encoder_seq, dtype, length,
                        device)


def fill_cross_cache(p, cfg, cache, enc_states: torch.Tensor) -> Dict:
    """Write each layer's cross K/V of ``enc_states`` [B, T_enc, D] into
    ``cache``, in place, as the reference's ``Model.make_cache`` fills
    them; returns the cache."""
    for i in range(cfg.num_layers):
        k, v = encode_memory_kv(_layer(p["decoder"]["cross_attn"], i), cfg,
                                enc_states)
        cache["cross"]["k"][i] = k
        cache["cross"]["v"][i] = v
    return cache
