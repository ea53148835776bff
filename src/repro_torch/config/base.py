"""Config dataclasses of the port (counterpart of ``repro/config/base.py``).

``ModelConfig`` keeps every field of the reference's, with its names,
defaults and checks, for the eight families: the paper's classifiers
``cnn`` and ``mlp``, the decoder-only LMs ``dense`` and ``moe``, the
attention-free Mamba2 ``ssm`` stack, the Jamba-style ``hybrid``
interleave, the Whisper-style ``encdec`` and the ``vlm``. ``FedConfig`` keeps
every field of the reference's, with its names, defaults and checks
(``server_test_fraction`` is read by nothing, in the reference too, and
comes over inert). ``cohort`` > 0 is the population tier's slot capacity
(``repro_torch.core.engine.population``), checked as the reference
checks it. ``MeshConfig`` is the reference's mesh shape and axis names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# the LM families the port serves (``Model.prefill`` / ``decode_step``)
LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# those the LM round trains (``--dataset lm``). The reference's round
# batches tokens alone: it trains a vlm on its text without patches (its
# patch_proj gets a zero gradient), and for encdec it fails (its
# forward_train reads batch["frames"], which batchify never makes)
ROUND_LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters, with the reference's names and
    defaults.

    * ``dense`` — decoder-only transformer (GQA, optional qk-norm and
      qkv-bias, RoPE, SwiGLU, RMSNorm).
    * ``moe`` — decoder-only with a top-k mixture-of-experts FFN on the
      layers where ``layer_idx % moe_every == moe_offset``.
    * ``ssm`` — attention-free Mamba2 (SSD) stack.
    * ``hybrid`` — Jamba-style Mamba/attention interleave (attention
      where ``layer_idx % attn_every == attn_offset``) with periodic MoE.
    * ``encdec`` — Whisper-style encoder-decoder (the audio frontend a
      stub: ``encoder_seq`` frame embeddings).
    * ``vlm`` — decoder-only over ``num_patches`` stub patch embeddings
      and the text.
    * ``cnn`` — 3x3 conv + relu + 2x2 max-pool per entry of
      ``cnn_channels``, then two dense layers (Sec. III).
    * ``mlp`` — the MNIST fully-connected classifier.
    """

    name: str
    family: str
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention details -------------------------------------------------
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    sliding_window: Optional[int] = None  # None = full causal attention
    max_position: int = 131_072

    # --- mixture of experts -------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_every: int = 1          # a layer uses MoE FFN iff layer_idx % moe_every == moe_offset
    moe_offset: int = 0
    router_aux_coef: float = 0.01

    # --- state-space (Mamba2 / SSD) ------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # --- hybrid interleave (Jamba) -------------------------------------------
    attn_every: int = 0         # attention layer iff layer_idx % attn_every == attn_offset
    attn_offset: int = 0

    # --- encoder-decoder (Whisper) -------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0        # fixed 1500 mel-frame positions for whisper
    decoder_max_position: int = 0

    # --- modality frontend stub ----------------------------------------------
    frontend: Optional[str] = None  # 'audio' | 'vision' | None
    num_patches: int = 0            # vlm: image patch embeddings per sample

    # --- cnn / mlp (the paper's classifiers) --------------------------------
    image_size: int = 0
    image_channels: int = 0
    cnn_channels: Tuple[int, ...] = ()
    cnn_hidden: int = 0
    num_classes: int = 0
    mlp_hidden: Tuple[int, ...] = ()

    # --- numerics / misc -----------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""            # citation for the config (paper / model card)

    def __post_init__(self) -> None:
        _require(self.family in LM_FAMILIES + ("cnn", "mlp"),
                 f"unknown family {self.family!r}")
        if self.family == "ssm":
            _require(self.ssm_state > 0, f"{self.name}: ssm needs state size")
            _require(self.num_layers > 0 and self.d_model > 0
                     and self.vocab_size > 0,
                     f"{self.name}: ssm needs num_layers, d_model and "
                     "vocab_size")
            return
        if self.family in ("dense", "moe", "hybrid", "encdec", "vlm"):
            _require(self.num_heads > 0 and self.num_kv_heads > 0,
                     f"{self.name}: attention archs need heads")
            _require(self.num_heads % self.num_kv_heads == 0,
                     f"{self.name}: num_heads must be divisible by "
                     "num_kv_heads")
            _require(self.num_layers > 0 and self.d_model > 0
                     and self.head_dim > 0 and self.d_ff > 0
                     and self.vocab_size > 0,
                     f"{self.name}: {self.family} needs num_layers, "
                     "d_model, head_dim, d_ff and vocab_size")
            if self.family == "moe":
                _require(self.num_experts > 0
                         and self.num_experts_per_tok > 0,
                         f"{self.name}: moe needs experts")
            if self.family == "hybrid":
                _require(self.attn_every > 0,
                         f"{self.name}: hybrid needs attn_every")
            if self.family == "encdec":
                _require(self.encoder_layers > 0 and self.encoder_seq > 0,
                         f"{self.name}: encdec needs encoder dims")
            return
        _require(self.num_classes > 0 and self.image_size > 0,
                 f"{self.name}: needs num_classes and image_size")
        if self.family == "cnn":
            _require(len(self.cnn_channels) > 0 and self.cnn_hidden > 0
                     and self.image_channels > 0,
                     f"{self.name}: cnn needs cnn_channels, cnn_hidden and "
                     "image_channels")
        if self.family == "mlp":
            _require(len(self.mlp_hidden) > 0,
                     f"{self.name}: mlp needs mlp_hidden, num_classes "
                     "and image_size")

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def uses_attention(self, layer_idx: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return layer_idx % self.attn_every == self.attn_offset
        return True

    def uses_moe(self, layer_idx: int) -> bool:
        if not self.has_moe:
            return False
        return layer_idx % self.moe_every == self.moe_offset

    def supports_long_context(self) -> bool:
        """True if the arch can serve a 524k-token KV without quadratic
        attention: ssm trivially, hybrid with its attention bounded,
        dense / moe / vlm through the sliding-window variant the dry-run
        applies; not encdec, whose decoder stops at 448 positions."""
        return self.family != "encdec"

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count, from the param tree's shapes."""
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """As :meth:`param_count`, each expert bank counted at
        ``num_experts_per_tok`` of its ``num_experts`` experts."""
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self, active_only=True)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests (the
    reference's ``reduce_for_smoke``):
    at most 2 layers, d_model <= 256, vocab <= 512, at most 4 query
    heads of width 32, d_ff <= 512, at most 4 experts (top-2); an SSM
    state <= 16 in heads of 32, chunk 32; a hybrid stack keeps one
    attention layer of its two (``attn_every`` 2, offset 1); an encdec
    keeps at most 2 encoder layers over 64 frames and a 128-row position
    table; a vlm at most 16 patches."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2),
        d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512) if cfg.vocab_size else 0,
        max_position=4096,
    )
    if cfg.num_heads:
        heads = min(cfg.num_heads, 4)
        kv = min(cfg.num_kv_heads, heads)
        while heads % kv:
            kv -= 1
        kw.update(num_heads=heads, num_kv_heads=kv, head_dim=32)
    if cfg.d_ff:
        kw.update(d_ff=min(cfg.d_ff, 512))
    if cfg.num_experts:
        kw.update(num_experts=min(cfg.num_experts, 4),
                  num_experts_per_tok=min(cfg.num_experts_per_tok, 2))
    if cfg.ssm_state:
        kw.update(ssm_state=min(cfg.ssm_state, 16), ssm_head_dim=32,
                  ssm_chunk=32)
    if cfg.family == "hybrid":
        # keep one attention layer in the 2-layer smoke stack
        kw.update(attn_every=2, attn_offset=1, moe_every=cfg.moe_every)
    if cfg.family == "encdec":
        kw.update(encoder_layers=min(cfg.encoder_layers, 2), encoder_seq=64,
                  decoder_max_position=128)
    if cfg.family == "vlm":
        kw.update(num_patches=min(cfg.num_patches, 16))
    if cfg.family == "cnn":
        kw.update(cnn_channels=tuple(min(c, 16) for c in cfg.cnn_channels),
                  cnn_hidden=min(cfg.cnn_hidden, 64))
    if cfg.family == "mlp":
        kw.update(mlp_hidden=tuple(min(h, 64) for h in cfg.mlp_hidden))
    return cfg.replace(**kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One workload shape of the dry-run."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    def __post_init__(self) -> None:
        _require(self.kind in ("train", "prefill", "decode"), self.kind)


INPUT_SHAPES: Mapping[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _freeze_kwargs(kw: Any) -> Tuple[Tuple[str, Any], ...]:
    """Normalise a strategy-kwargs mapping to a hashable sorted tuple."""
    if kw is None:
        return ()
    items = kw.items() if isinstance(kw, Mapping) else tuple(kw)
    out = []
    for k, v in sorted(items):
        if isinstance(v, list):
            v = tuple(v)
        out.append((str(k), v))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """The paper's knobs (Sec. III, Algorithm 1), the reference's fields.
    ``aggregator`` / ``attack`` / ``selector`` / ``coalition`` /
    ``fault`` / ``compressor`` are names in the port's registries
    (:mod:`repro_torch.strategies`); each ``*_kwargs`` mapping goes to
    the strategy's constructor, stored as a sorted tuple.

    ``fault`` names a client-failure model whose survival mask is ANDed
    into the participation mask after selection (DESIGN.md §9);
    ``coalition`` a coordinated adversary of ``coalition_size`` members
    (or ``size=`` / ``indices=`` in ``coalition_kwargs``), counted as
    malicious in union with the ``attack``'s set (DESIGN.md §7);
    ``lying_testers`` makes testers with id below it report uniform
    draws (Sec. V-C). ``cohort`` is the population tier's per-round slot
    capacity C (DESIGN.md §11): 0 is dense, and 0 < C < N needs
    ``participation`` < 1 (about C/N)."""

    num_users: int = 20
    num_testers: int = 5
    num_malicious: int = 0
    rounds: int = 100
    local_steps: int = 20
    score_power: float = 4.0
    power_warmup_rounds: int = 2
    score_decay: float = 0.5
    aggregator: str = "fedtest"
    aggregator_kwargs: Any = ()
    attack: str = "random_weights"
    attack_kwargs: Any = ()
    attack_scale: float = 1.0
    selector: str = "rotating"
    selector_kwargs: Any = ()
    coalition: str = "none"
    coalition_kwargs: Any = ()     # e.g. boost_to=0.9, placement='first'
    coalition_size: int = 0
    fault: str = "none"
    fault_kwargs: Any = ()         # e.g. deadline=2.0, placement='first'
    fault_rate: float = 0.1        # default drop rate offered to faults
    lying_testers: int = 0
    # the accuracy-based baseline's server test set; nothing reads it, as
    # in the reference, whose builder takes its own server_frac=0.1
    server_test_fraction: float = 0.1
    participation: float = 1.0
    crosstest_impl: str = "batched"    # 'batched' | 'reference'
    compressor: str = "identity"
    compressor_kwargs: Any = ()
    cohort: int = 0
    seed: int = 0

    def __post_init__(self) -> None:
        _require(0 < self.num_testers <= self.num_users, "need 0 < K <= N")
        _require(0 <= self.cohort <= self.num_users,
                 f"cohort={self.cohort} must be in [0, "
                 f"num_users={self.num_users}] (C > N gathers clients "
                 "that do not exist)")
        if 0 < self.cohort < self.num_users:
            _require(self.participation < 1.0,
                     "cohort < num_users requires participation < 1.0 "
                     "(with everyone sampled, cohort truncation would "
                     "bias toward low client indices); set "
                     "participation ≈ cohort/num_users")
        _require(self.num_malicious < self.num_users, "M < N")
        _require(self.coalition_size < self.num_users, "coalition_size < N")
        _require(0.0 <= self.fault_rate < 1.0, "fault_rate in [0, 1)")
        _require(0.0 < self.participation <= 1.0,
                 f"participation={self.participation} must be in (0, 1]")
        _require(self.crosstest_impl in ("batched", "reference"),
                 f"crosstest_impl must be 'batched'|'reference', "
                 f"got {self.crosstest_impl!r}")
        for f in ("aggregator_kwargs", "attack_kwargs", "selector_kwargs",
                  "coalition_kwargs", "fault_kwargs", "compressor_kwargs"):
            object.__setattr__(self, f, _freeze_kwargs(getattr(self, f)))
        # lazy import: repro_torch.strategies never imports the config
        from repro_torch.strategies import (
            AGGREGATORS, ATTACKS, COALITIONS, COMPRESSORS, FAULTS,
            SELECTORS)
        AGGREGATORS.get(self.aggregator)
        ATTACKS.get(self.attack)
        SELECTORS.get(self.selector)
        COALITIONS.get(self.coalition)
        FAULTS.get(self.fault)
        COMPRESSORS.get(self.compressor)
        # a named coalition needs members and members need a named
        # coalition, else the run silently measures no adversary; they
        # come from coalition_size or coalition_kwargs' size= / indices=
        if self.coalition != "none":
            kw = dict(self.coalition_kwargs)
            idx = kw.get("indices") or ()
            members = (self.coalition_size or int(kw.get("size") or 0)
                       or len(idx))
            _require(members > 0,
                     f"coalition {self.coalition!r} needs members: set "
                     "coalition_size > 0 or pass size=/indices= in "
                     "coalition_kwargs")
            _require(members < self.num_users, "coalition members < N")
            _require(all(0 <= int(i) < self.num_users for i in idx),
                     f"coalition indices {tuple(idx)} out of range for "
                     f"num_users={self.num_users}")
        else:
            _require(self.coalition_size == 0,
                     "coalition_size > 0 but coalition='none' — name "
                     "the coalition (e.g. coalition='mutual_boost')")

    def strategy_kwargs(self, field: str) -> dict:
        """``aggregator`` | ``attack`` | ``selector`` | ``coalition`` |
        ``fault`` | ``compressor`` kwargs as a dict."""
        return dict(getattr(self, field + "_kwargs"))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"       # 'sgd' | 'momentum' | 'adam' | 'adamw'
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    momentum: float = 0.9
    schedule: str = "cosine"       # 'constant' | 'cosine' | 'linear_warmup_cosine'
    warmup_steps: int = 100
    total_steps: int = 1_000
    grad_clip: float = 1.0
    batch_size: int = 32
    remat: bool = True             # a checkpoint a layer in launch/steps


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    def __post_init__(self) -> None:
        _require(len(self.shape) == len(self.axes), "shape/axes mismatch")

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)
