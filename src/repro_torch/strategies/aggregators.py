"""Registered aggregation strategies (counterpart of
``repro/strategies/aggregators.py``).

Weights path — a ``[N]`` simplex reduced by ``weighted_aggregate``:

* ``fedtest`` — moving-average accuracy^p scores from peer testers (the
  paper's contribution, Sec. III), with the optional tester-trust
  consensus and report clipping of Sec. V-C.
* ``fedavg``  — weights proportional to client sample counts.
* ``accuracy_based`` — weights from each model's accuracy on the server's
  held-out set (``ctx.server_eval``; the baseline of Fig. 3a).
* ``uniform`` — plain mean, the no-defence control.
* ``krum``, ``trimmed_mean``, ``median`` — the robust baselines over
  ``ctx.updates`` (the ``[N, D]`` f32 update matrix): Multi-Krum, the
  client-level trimmed mean, and geometric-median (Weiszfeld) weights.

Combine path — a per-coordinate order statistic over ``ctx.updates``,
the ``robust_combine`` kernel:

* ``trimmed_mean_coord`` and ``median_coord``, each with an optional
  ``score_gate`` on the FedTest scores.

Under client sampling every robust statistic stays inside the sampled
subset (``ctx.participation``): a non-participant's slot holds the stale
global model, an all-zero update row.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import (
    accuracy_based_weights, fedavg_weights)
from repro_torch.core.scoring import (
    _consensus_median, score_weights, update_scores, update_tester_trust)
from repro_torch.kernels.robust_combine import robust_combine
from repro_torch.strategies.base import (
    AGGREGATORS, Aggregator, RoundContext, register)


def _mask_to_simplex(mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return m / torch.clamp(m.sum(), min=1e-9)


def _one_hot_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    mask = torch.zeros((n,), dtype=torch.float32, device=idx.device)
    return mask.index_fill(0, idx, 1.0)


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
        return fedavg_weights(ctx.counts)


@register(AGGREGATORS, "accuracy_based")
class AccuracyBased(Aggregator):
    """Server-side accuracy weighting (the baseline of Fig. 3a). It takes
    ``power``, not ``score_power``, so the engine's scoring defaults never
    reach it."""

    needs_server_eval = True

    def __init__(self, *, power: float = 1.0):
        self.power = float(power)

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        return accuracy_based_weights(ctx.server_eval(), self.power)


def _pairwise_sq_dists(u: torch.Tensor) -> torch.Tensor:
    """[N, D] -> [N, N] squared euclidean distances."""
    sq = (u * u).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (u @ u.T)
    return torch.clamp(d2, min=0.0)


# non-participant exclusion distance: finite (inf would poison the
# neighbour sums when k exceeds the sampled-subset size) but far above
# any real update distance, so excluded pairs are always ranked last
_FAR = 1e12


def _krum_scores(u: torch.Tensor, num_byzantine: int,
                 part=None) -> torch.Tensor:
    """Krum score per client: sum of sq-dists to its n-f-2 nearest peers;
    ``part`` [N] keeps the selection inside the sampled subset."""
    n = u.shape[0]
    d2 = _pairwise_sq_dists(u)
    eye = torch.eye(n, dtype=torch.bool, device=u.device)
    d2 = torch.where(eye, _FAR, d2)                      # exclude self
    if part is not None:
        excl = (part[:, None] <= 0) | (part[None, :] <= 0)
        d2 = torch.where(excl, _FAR, d2)
    k = max(1, min(n - 1, n - num_byzantine - 2))
    nearest = torch.topk(d2, k, dim=1, largest=False).values
    scores = nearest.sum(dim=1)
    if part is not None:
        scores = torch.where(part > 0, scores, torch.inf)
    return scores


@register(AGGREGATORS, "krum")
class Krum(Aggregator):
    """Krum / Multi-Krum [Blanchard et al., NeurIPS'17]: the ``multi``
    clients with the smallest Krum score, weighed uniformly.
    ``num_byzantine`` (the defender's assumed f) defaults to
    ``FedConfig.num_malicious``."""

    needs_updates = True

    def __init__(self, *, num_byzantine: int = 0, multi: int = 1):
        self.num_byzantine = int(num_byzantine)
        self.multi = max(1, int(multi))

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        scores = _krum_scores(ctx.updates, self.num_byzantine,
                              part=ctx.participation)
        n = scores.shape[0]
        best = torch.topk(scores, min(self.multi, n), largest=False).indices
        mask = _one_hot_mask(best, n)
        if ctx.participation is not None:
            mask = mask * ctx.participation
        return _mask_to_simplex(mask)


@register(AGGREGATORS, "trimmed_mean")
class TrimmedMean(Aggregator):
    """Client-level trimmed mean [after Yin et al., ICML'18]: drop the
    ``trim_fraction`` of clients farthest from the coordinate-wise median
    update, average the rest uniformly."""

    needs_updates = True

    def __init__(self, *, trim_fraction: float = 0.2):
        if not 0.0 <= trim_fraction < 1.0:
            raise ValueError(f"trim_fraction in [0, 1), got {trim_fraction}")
        self.trim_fraction = float(trim_fraction)

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        u = ctx.updates
        n = u.shape[0]
        part = ctx.participation
        # the consensus averages the two middle values on an even count,
        # as jnp.median / jnp.nanmedian do, over the sampled subset only
        med = _consensus_median(u, part)
        dist = torch.linalg.norm(u - med[None, :], dim=1)
        if part is not None:
            dist = torch.where(part > 0, dist, torch.inf)
        keep = max(1, n - int(round(self.trim_fraction * n)))
        kept = torch.topk(dist, keep, largest=False).indices
        mask = _one_hot_mask(kept, n)
        if part is not None:
            mask = mask * part
        return _mask_to_simplex(mask)


@register(AGGREGATORS, "median")
class GeometricMedian(Aggregator):
    """Geometric-median weights via Weiszfeld iteration:
    ``w_i ∝ 1 / ||u_i - mu||`` around the current weighted mean ``mu``."""

    needs_updates = True

    def __init__(self, *, iters: int = 4, eps: float = 1e-6):
        self.iters = int(iters)
        self.eps = float(eps)

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        u = ctx.updates
        gate = (torch.ones((u.shape[0],), dtype=torch.float32,
                           device=u.device)
                if ctx.participation is None else ctx.participation)
        w = gate / torch.clamp(gate.sum(), min=1e-9)
        for _ in range(self.iters):
            mu = torch.mv(u.T, w)
            dist = torch.linalg.norm(u - mu[None, :], dim=1)
            w = gate / (dist + self.eps)
            w = w / torch.clamp(w.sum(), min=1e-12)
        return w


class _CoordRobust(Aggregator):
    """Shared machinery of the per-coordinate combine aggregators.

    The client gate mask decides who enters the order statistic: everyone
    by default, optionally filtered by the FedTest moving-average scores
    (``score_gate``), always intersected with the participation mask.
    ``weights()`` returns the normalised gate, for reporting only. The
    aggregators keep the FedTest scores themselves, so the gate has a
    live cross-testing signal to act on.
    """

    needs_updates = True
    _mode = "trimmed_mean"

    def __init__(self, *, trim_fraction: float = 0.2,
                 score_gate: float = 0.0, score_power: float = 4.0,
                 score_decay: float = 0.5, power_warmup_rounds: int = 2):
        if not 0.0 <= trim_fraction < 1.0:
            raise ValueError(f"trim_fraction in [0, 1), got {trim_fraction}")
        if not 0.0 <= score_gate <= 1.0:
            raise ValueError(f"score_gate in [0, 1], got {score_gate}")
        self.trim_fraction = float(trim_fraction)
        self.score_gate = float(score_gate)
        self.score_power = float(score_power)
        self.score_decay = float(score_decay)
        self.power_warmup_rounds = int(power_warmup_rounds)

    def update_scores(self, ctx: RoundContext):
        return update_scores(ctx.scores, ctx.acc_matrix, ctx.tester_ids,
                             power=self.score_power,
                             decay=self.score_decay,
                             power_warmup_rounds=self.power_warmup_rounds,
                             row_mask=ctx.report_mask,
                             client_mask=ctx.participation)

    def gate_mask(self, ctx: RoundContext) -> torch.Tensor:
        mask = torch.ones((ctx.num_users,), dtype=torch.float32,
                          device=ctx.counts.device)
        if self.score_gate > 0.0:
            s = torch.clamp(ctx.scores.scores, min=0.0)
            gated = (s >= self.score_gate * s.max()).float()
            # before any scores exist (round 0) the gate is degenerate:
            # keep everyone until the signal is non-zero
            mask = torch.where(s.max() > 0.0, gated, mask)
        if ctx.participation is not None:
            mask = mask * ctx.participation
        # the statistic needs at least one client; an empty gate falls
        # back to the full participation set
        fallback = (ctx.participation if ctx.participation is not None
                    else torch.ones_like(mask))
        return torch.where(mask.sum() > 0.0, mask, fallback)

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        return _mask_to_simplex(self.gate_mask(ctx))

    def combine(self, ctx: RoundContext, updates: torch.Tensor
                ) -> torch.Tensor:
        return robust_combine(updates, mask=self.gate_mask(ctx),
                              mode=self._mode,
                              trim_fraction=self.trim_fraction)


@register(AGGREGATORS, "trimmed_mean_coord")
class CoordTrimmedMean(_CoordRobust):
    """Coordinate-wise beta-trimmed mean [Yin et al., ICML'18]."""

    _mode = "trimmed_mean"


@register(AGGREGATORS, "median_coord")
class CoordMedian(_CoordRobust):
    """Coordinate-wise median [Yin et al., ICML'18]."""

    _mode = "median"


@register(AGGREGATORS, "uniform")
class Uniform(Aggregator):
    """Plain mean — the no-defence control."""

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        n = ctx.num_users
        return torch.full((n,), 1.0 / n, dtype=torch.float32,
                          device=ctx.counts.device)
