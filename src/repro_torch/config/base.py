"""Config dataclasses of the port (counterpart of ``repro/config/base.py``).

``ModelConfig`` carries only the fields of the two families the port
runs, ``cnn`` and ``mlp``. ``FedConfig`` keeps the reference's fields
that the round reads, with the reference's names and defaults; a field
comes over with the slice that first reads it. The strategy names this
slice does not run yet are refused with the ``ROADMAP.md`` item that
will port them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyper-parameters of the paper's classifiers.

    * ``cnn`` — 3x3 conv + relu + 2x2 max-pool per entry of
      ``cnn_channels``, then two dense layers (Sec. III).
    * ``mlp`` — the MNIST fully-connected classifier.
    """

    name: str
    family: str
    image_size: int = 0
    image_channels: int = 0
    cnn_channels: Tuple[int, ...] = ()
    cnn_hidden: int = 0
    num_classes: int = 0
    mlp_hidden: Tuple[int, ...] = ()
    dtype: str = "float32"

    def __post_init__(self) -> None:
        _require(self.family in ("cnn", "mlp"),
                 f"family {self.family!r} is not ported yet; the port runs "
                 "'cnn' and 'mlp' (LM families: ROADMAP.md queue 1 item 16)")
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

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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


# FedConfig values the reference runs and this slice does not, each with
# the ROADMAP.md queue-1 item that ports it
_NOT_PORTED = (
    ("coalition", "none", "item 11 (adversary surface)"),
    ("coalition_size", 0, "item 11 (adversary surface)"),
    ("lying_testers", 0, "item 11 (adversary surface)"),
    ("fault", "none", "item 10 (durability and faults)"),
    ("cohort", 0, "item 14 (population tier)"),
)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """The paper's knobs (Sec. III, Algorithm 1), a subset of the
    reference's fields. ``aggregator`` / ``attack`` / ``selector`` /
    ``compressor`` are names in the port's registries
    (:mod:`repro_torch.strategies`); each ``*_kwargs`` mapping goes to
    the strategy's constructor, stored as a sorted tuple."""

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
    coalition_size: int = 0
    fault: str = "none"
    lying_testers: int = 0
    participation: float = 1.0
    compressor: str = "identity"
    compressor_kwargs: Any = ()
    cohort: int = 0
    seed: int = 0

    def __post_init__(self) -> None:
        _require(0 < self.num_testers <= self.num_users, "need 0 < K <= N")
        _require(self.num_malicious < self.num_users, "M < N")
        _require(0.0 < self.participation <= 1.0,
                 f"participation={self.participation} must be in (0, 1]")
        for field, default, item in _NOT_PORTED:
            _require(getattr(self, field) == default,
                     f"{field}={getattr(self, field)!r} is not ported yet "
                     f"(ROADMAP.md queue 1 {item}); the port runs "
                     f"{field}={default!r}")
        for f in ("aggregator_kwargs", "attack_kwargs", "selector_kwargs",
                  "compressor_kwargs"):
            object.__setattr__(self, f, _freeze_kwargs(getattr(self, f)))
        # lazy import: repro_torch.strategies never imports the config
        from repro_torch.strategies import (
            AGGREGATORS, ATTACKS, COMPRESSORS, SELECTORS)
        AGGREGATORS.get(self.aggregator)
        ATTACKS.get(self.attack)
        SELECTORS.get(self.selector)
        COMPRESSORS.get(self.compressor)

    def strategy_kwargs(self, field: str) -> dict:
        """``aggregator`` | ``attack`` | ``selector`` | ``compressor``
        kwargs as a dict."""
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
