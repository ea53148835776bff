"""Registered aggregation strategies (the weights-path entries of
``repro/strategies/aggregators.py`` that this slice runs).

* ``fedtest`` — moving-average accuracy^p scores from peer testers (the
  paper's contribution, Sec. III), with the optional tester-trust
  consensus and report clipping of Sec. V-C.
* ``fedavg``  — weights proportional to client sample counts.
* ``uniform`` — plain mean, the no-defence control.
"""
from __future__ import annotations

import torch

from repro_torch.core.scoring import (
    score_weights, update_scores, update_tester_trust)
from repro_torch.strategies.base import (
    AGGREGATORS, Aggregator, RoundContext, register)


@register(AGGREGATORS, "fedtest")
class FedTest(Aggregator):
    """The paper's scheme: normalised moving-average accuracy^p scores.

    ``use_trust`` down-weights testers whose reports deviate from the
    per-round consensus median (memory ``trust_decay``); ``report_clip``
    winsorises reports against that median before they are combined.
    """

    def __init__(self, *, score_power: float = 4.0, score_decay: float = 0.5,
                 power_warmup_rounds: int = 2, use_trust: bool = False,
                 trust_decay: float = 0.8, report_clip: float = 0.0):
        if not 0.0 <= trust_decay <= 1.0:
            raise ValueError(f"trust_decay in [0, 1], got {trust_decay}")
        if not 0.0 <= report_clip <= 1.0:
            raise ValueError(f"report_clip in [0, 1], got {report_clip}")
        self.score_power = float(score_power)
        self.score_decay = float(score_decay)
        self.power_warmup_rounds = int(power_warmup_rounds)
        self.use_trust = bool(use_trust)
        self.trust_decay = float(trust_decay)
        self.report_clip = float(report_clip)

    def update_scores(self, ctx: RoundContext):
        scores = ctx.scores
        if self.use_trust:
            scores = update_tester_trust(scores, ctx.acc_matrix,
                                         ctx.tester_ids,
                                         decay=self.trust_decay,
                                         row_mask=ctx.report_mask)
        return update_scores(scores, ctx.acc_matrix, ctx.tester_ids,
                             power=self.score_power,
                             decay=self.score_decay,
                             use_trust=self.use_trust,
                             power_warmup_rounds=self.power_warmup_rounds,
                             row_mask=ctx.report_mask,
                             client_mask=ctx.participation,
                             report_clip=self.report_clip or None)

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        return score_weights(ctx.scores)


@register(AGGREGATORS, "fedavg")
class FedAvg(Aggregator):
    """Weights proportional to client sample counts [McMahan et al.]."""

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        c = ctx.counts.float()
        return c / torch.clamp(c.sum(), min=1e-9)


@register(AGGREGATORS, "uniform")
class Uniform(Aggregator):
    """Plain mean — the no-defence control."""

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        n = ctx.num_users
        return torch.full((n,), 1.0 / n, dtype=torch.float32,
                          device=ctx.counts.device)
