"""Family-independent model facade (the port's side of
``repro/models/model.py``).

    m = build_model(cfg)
    params = m.init(gen)                       # on gen's device
    logits = m.forward_train(params, batch)
    loss, metrics = m.loss(params, batch)
    logits, cache = m.prefill(params, batch, cache_len=...)   # the LMs
    logits, cache = m.decode_step(params, cache, tokens)      # the LMs

Batch conventions:

* the decoder LMs (dense/moe/ssm/hybrid): ``{"tokens": [B,S] int,
  "labels": [B,S]}``;
* vlm: also ``{"patches": [B,P,D]}``; the logits cover patches + text,
  and labels of the text alone are padded with -1 (ignored) over the
  patch prefix;
* encdec: ``{"frames": [B,T_enc,D], "tokens": [B,S], "labels": [B,S]}``;
* cnn/mlp: ``{"images": [B,H,W,C], "labels": [B]}``.

An LM's full-sequence attention and scan run the kernel ops
(``flash_attention``, ``ssd_scan``: serve and eval), or, with
``differentiable``, their differentiable twins (``blockwise_attention``,
``ssd_chunked``), which the round's local training takes (the kernels are
forward-only). cnn/mlp ignore it. A MoE layer (the ``moe`` and
``hybrid`` families) routes by capacity over groups of
``moe_group_size`` tokens (0: 512), or dropless with ``moe_dropless``;
decode is always dropless. An LM's loss is ``nll + router_aux_coef *
moe_aux``, the MoE load-balance loss summed over the layers (0 without
MoE); ``loss(..., remat=True)`` checkpoints each layer, and a decoder
LM's ``ce_chunk`` > 0 computes it in sequence chunks of that many rows,
never holding the ``[B, S, V]`` f32 logits (``_chunked_ce``). An encdec's
learned position table has ``max(decoder_max_position,
max_target_positions)`` rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.config import LM_FAMILIES, ModelConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import decoder as dec_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (
    argmax_vocab, gold_logits, softmax_cross_entropy, token_accuracy)
from repro_torch.utils import flat_names, tree_leaves, tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    differentiable: bool = False           # LM: the twins, not the kernels
    sliding_window: Optional[int] = None   # long-context serving variant
    moe_dropless: bool = False             # exact per-token routing
    moe_group_size: int = 0                # 0 = the MoE's default (512)
    max_target_positions: int = 0          # encdec learned-pos extension
    ce_chunk: int = 0                      # >0: chunked cross-entropy
    # the classifier family's weightless module, driven through
    # functional_call (None for the LMs, which are plain functions)
    net: Optional[torch.nn.Module] = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        nets = {"cnn": cnn_mod.CNN, "mlp": mlp_mod.MLP}
        object.__setattr__(self, "net", nets[self.cfg.family](self.cfg)
                           if self.cfg.family in nets else None)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    def _lm(self) -> bool:
        return self.cfg.family in LM_FAMILIES

    def _specs(self) -> Dict[str, Any]:
        """An LM's tree of ``(shape, dtype)`` leaves."""
        if self.cfg.family == "encdec":
            return encdec_mod.encdec_specs(self.cfg, self.dtype,
                                           self.max_target_positions)
        return dec_mod.decoder_specs(self.cfg, self.dtype)

    def param_shapes(self) -> Dict[str, Any]:
        """Nested dict of leaf shapes, in the reference's tree."""
        if self._lm():
            return tree_map(lambda s: s[0], self._specs())
        if self.cfg.family == "cnn":
            return cnn_mod.cnn_param_shapes(self.cfg)
        return mlp_mod.mlp_param_shapes(self.cfg)

    def param_dtypes(self) -> Dict[str, Any]:
        """Nested dict of leaf dtypes: the model's dtype, except the LMs'
        RMSNorm and LayerNorm params, the MoE router and the mamba block's
        ``dt_bias``, ``A_log`` and ``D``, which stay f32 as the reference
        keeps them."""
        if self._lm():
            return tree_map(lambda s: s[1], self._specs())
        return tree_map(lambda _: self.dtype, self.param_shapes())

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Fresh params, drawn from ``gen`` on its device."""
        if self.cfg.family == "encdec":
            return encdec_mod.init_encdec(self.cfg, gen, self.dtype,
                                          self.max_target_positions)
        if self._lm():
            return dec_mod.init_decoder(self.cfg, gen, self.dtype)
        if self.cfg.family == "cnn":
            return cnn_mod.init_cnn(self.cfg, gen, self.dtype)
        return mlp_mod.init_mlp(self.cfg, gen, self.dtype)

    def _lm_forward(self, params, batch, **kw):
        """An LM's (logits, aux, cache or None) over ``batch``: an encdec
        encodes ``frames`` and decodes ``tokens`` against them; the
        decoder stack takes a vlm's ``patches`` before the tokens."""
        if self.cfg.family == "encdec":
            enc = encdec_mod.encode(params, self.cfg, batch["frames"],
                                    differentiable=self.differentiable)
            return encdec_mod.decode_full(
                params, self.cfg, batch["tokens"], enc,
                differentiable=self.differentiable, **kw)
        return dec_mod.decoder_forward(
            params, self.cfg, batch["tokens"],
            prefix_embeds=batch.get("patches"),
            sliding_window=self.sliding_window,
            differentiable=self.differentiable,
            moe_dropless=self.moe_dropless,
            moe_group_size=self.moe_group_size, **kw)

    def forward_train(self, params, batch) -> torch.Tensor:
        """Logits: ``[B, num_classes]`` (cnn/mlp) or ``[B, S, V]`` (LM;
        ``[B, P + S, V]`` for a vlm)."""
        if self._lm():
            return self._lm_forward(params, batch)[0]
        return functional_call(self.net, flat_names(params),
                               (batch["images"],))

    @staticmethod
    def _pad_labels(labels, rows: int):
        """A vlm's text labels padded with -1 over its patch prefix."""
        pad = rows - labels.shape[1]
        if not pad:
            return labels
        return torch.cat([labels.new_full((labels.shape[0], pad), -1),
                          labels], dim=1)

    def _chunked_ce(self, params, batch, *, remat: bool):
        """Sequence-chunked cross-entropy of a decoder LM: the head matmul
        and the softmax run ``ce_chunk`` rows at a time (the whole
        sequence where ``ce_chunk`` does not divide it), so the [B,S,V]
        f32 logits are never held; with ``remat`` each chunk is
        recomputed in the backward."""
        cfg = self.cfg
        hidden, aux, _ = dec_mod.decoder_forward(
            params, cfg, batch["tokens"], prefix_embeds=batch.get("patches"),
            sliding_window=self.sliding_window,
            differentiable=self.differentiable,
            moe_dropless=self.moe_dropless,
            moe_group_size=self.moe_group_size, remat=remat,
            return_hidden=True)
        S = hidden.shape[1]
        labels = self._pad_labels(batch["labels"], S).long()
        head = dec_mod.lm_head(params, cfg)
        C = self.ce_chunk
        nc = S // C if S % C == 0 else 1
        C = S // nc

        def chunk(h, y):
            logits = (h @ head).float()
            valid = y != -1
            safe = torch.where(valid, y, torch.zeros_like(y))
            logz = torch.logsumexp(logits, dim=-1)
            gold = gold_logits(logits, safe)
            correct = (argmax_vocab(logits) == y) & valid
            return ((logz - gold) * valid).sum(), valid.sum(), correct.sum()

        nll_sum = n_valid = n_correct = 0
        for i in range(nc):
            h, y = hidden[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
            out = (checkpoint(chunk, h, y, use_reentrant=False) if remat
                   else chunk(h, y))
            nll_sum = nll_sum + out[0]
            n_valid = n_valid + out[1]
            n_correct = n_correct + out[2]
        nll = nll_sum / n_valid.clamp(min=1)
        acc = n_correct / n_valid.clamp(min=1)
        return (nll + cfg.router_aux_coef * aux,
                {"nll": nll, "accuracy": acc, "moe_aux": aux})

    def loss(self, params, batch, *, remat: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A classifier's NLL; an LM's ``nll + router_aux_coef *
        moe_aux``, with ``moe_aux`` among its metrics. A vlm's text labels
        are padded with -1 over the patch prefix. ``remat`` checkpoints an
        LM's layers; a decoder LM with ``ce_chunk`` takes
        :meth:`_chunked_ce`."""
        lm = self._lm()
        labels = batch["labels"]
        if lm and self.ce_chunk and self.cfg.family != "encdec":
            return self._chunked_ce(params, batch, remat=remat)
        if lm:
            logits, aux, _ = self._lm_forward(params, batch, remat=remat)
            if self.cfg.family == "vlm":
                labels = self._pad_labels(labels, logits.shape[1])
        else:
            logits = self.forward_train(params, batch)
        nll = softmax_cross_entropy(logits, labels)
        metrics = {"nll": nll, "accuracy": token_accuracy(logits, labels)}
        if not lm:
            return nll, metrics
        metrics["moe_aux"] = aux
        return nll + self.cfg.router_aux_coef * aux, metrics

    def _require_lm(self, what: str) -> None:
        if not self._lm():
            raise ValueError(f"{self.cfg.family} has no {what} path")

    def prefill(self, params, batch, *, cache_len: int = 0
                ) -> Tuple[torch.Tensor, Dict]:
        """Logits ``[B, S, V]`` (a vlm's ``[B, P + S, V]``) of the prompt
        and its cache: each attention slot's KV cache padded to
        ``cache_len`` rows, each mamba slot's conv and ssm states (an
        attention-free stack leaves ``cache_len`` unused, as in the
        reference); an encdec's self-attention cache and each layer's
        cross K/V."""
        self._require_lm("serving")
        logits, _, cache = self._lm_forward(params, batch, want_cache=True,
                                            cache_len=cache_len)
        return logits, cache

    def decode_step(self, params, cache, tokens) -> Tuple[torch.Tensor, Dict]:
        """Logits ``[B, 1, V]`` of one token a sequence; writes the cache
        in place and returns it with ``length + 1``."""
        self._require_lm("serving")
        if self.cfg.family == "encdec":
            return encdec_mod.decode_step(params, self.cfg, cache, tokens)
        return dec_mod.decoder_decode_step(
            params, self.cfg, cache, tokens,
            sliding_window=self.sliding_window)

    def make_cache(self, params, batch_size: int, capacity: int, *,
                   length: Optional[int] = None,
                   enc_states: Optional[torch.Tensor] = None) -> Dict:
        """A zeroed cache of ``capacity`` rows; an encdec's cross K/V
        filled from ``enc_states`` [B, T_enc, D], layer by layer."""
        self._require_lm("serving")
        device = params["embed"].device
        if self.cfg.family != "encdec":
            return dec_mod.make_empty_cache(
                self.cfg, batch_size, capacity, self.dtype, length=length,
                device=device)
        if enc_states is None:
            raise ValueError("an encdec cache needs enc_states")
        return encdec_mod.fill_cross_cache(
            params, self.cfg, encdec_mod.make_empty_cache(
                self.cfg, batch_size, capacity, self.dtype, length=length,
                device=device), enc_states)

    def param_count(self, params=None) -> int:
        if params is None:
            return self.cfg.param_count()
        return sum(x.numel() for x in tree_leaves(params))


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg=cfg, **kw)
