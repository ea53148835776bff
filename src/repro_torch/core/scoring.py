"""FedTest scoring (paper Sec. III + V-B), counterpart of
``repro/core/scoring.py``.

    s_c(t) = decay * s_c(t-1) + (1 - decay) * mean_k A[k, c]^p

with exponent 1 for the first ``power_warmup_rounds`` rounds. Weights
are the normalised scores; tester reports can be trust-weighted and
clipped to the consensus median (Sec. V-C). Everything stays on the
device: no value is read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ScoreState(NamedTuple):
    scores: torch.Tensor         # [N] moving-average accuracy^p
    rounds_seen: torch.Tensor    # 0-d int32
    tester_trust: torch.Tensor   # [N] moving agreement score (V-C)


def init_scores(num_users: int, device=None) -> ScoreState:
    return ScoreState(
        scores=torch.zeros((num_users,), dtype=torch.float32, device=device),
        rounds_seen=torch.zeros((), dtype=torch.int32, device=device),
        tester_trust=torch.ones((num_users,), dtype=torch.float32,
                                device=device))


def _consensus_median(acc_matrix: torch.Tensor,
                      row_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Per-client median over the (reporting) tester rows, averaging the
    two middle values on an even count as ``jnp.median`` does
    (``torch.median`` returns the lower one). All-masked columns give
    NaN."""
    k = acc_matrix.shape[0]
    if row_mask is None:
        s = torch.sort(acc_matrix, dim=0).values
        return 0.5 * s[(k - 1) // 2] + 0.5 * s[k // 2]
    valid = row_mask[:, None] > 0
    s = torch.sort(torch.where(valid, acc_matrix, torch.inf), dim=0).values
    n = valid.sum()
    lo = torch.clamp((n - 1) // 2, min=0).expand(1, s.shape[1])
    hi = torch.clamp(n // 2, max=k - 1).expand(1, s.shape[1])
    med = 0.5 * s.gather(0, lo)[0] + 0.5 * s.gather(0, hi)[0]
    return torch.where(n > 0, med, torch.nan)


def clip_reports_to_consensus(acc_matrix: torch.Tensor, clip: float,
                              row_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Winsorise tester reports into ``[median_c - clip, median_c + clip]``
    around the per-client consensus median."""
    median = _consensus_median(acc_matrix, row_mask)
    if row_mask is not None:
        median = torch.nan_to_num(median)     # nobody reported: clamp to 0
    return torch.clamp(acc_matrix, median[None, :] - clip,
                       median[None, :] + clip)


def combine_tester_reports(acc_matrix: torch.Tensor,
                           tester_ids: torch.Tensor,
                           trust: Optional[torch.Tensor] = None,
                           row_mask: Optional[torch.Tensor] = None,
                           clip: Optional[float] = None) -> torch.Tensor:
    """acc_matrix [K, N] -> per-client accuracy [N]; optionally
    trust-weighted, restricted to the reporting rows (``row_mask``) and
    winsorised (``clip``). Nobody reporting gives all zeros."""
    if clip is not None and clip > 0.0:
        acc_matrix = clip_reports_to_consensus(acc_matrix, clip, row_mask)
    if trust is None and row_mask is None:
        return acc_matrix.mean(dim=0)
    k = acc_matrix.shape[0]
    w = (torch.ones((k,), dtype=torch.float32, device=acc_matrix.device)
         if trust is None else trust[tester_ids])
    if row_mask is not None:
        w = w * row_mask
    total = w.sum()
    combined = (w / torch.clamp(total, min=1e-9)) @ acc_matrix
    return torch.where(total > 0.0, combined, torch.zeros_like(combined))


def update_tester_trust(state: ScoreState, acc_matrix: torch.Tensor,
                        tester_ids: torch.Tensor, decay: float = 0.8,
                        row_mask: Optional[torch.Tensor] = None
                        ) -> ScoreState:
    """Sec. V-C: testers whose reports deviate from the consensus median
    lose trust; non-reporting testers (``row_mask``) keep theirs."""
    median = _consensus_median(acc_matrix, row_mask)                # [N]
    dev = torch.abs(acc_matrix - median[None, :]).mean(dim=1)      # [K]
    agreement = torch.exp(-4.0 * dev)
    old = state.tester_trust[tester_ids]
    updated = decay * old + (1 - decay) * agreement
    if row_mask is not None:
        updated = torch.where(row_mask > 0, updated, old)
    new_trust = state.tester_trust.clone()
    new_trust[tester_ids] = updated
    return state._replace(tester_trust=new_trust)


def update_scores(state: ScoreState, acc_matrix: torch.Tensor,
                  tester_ids: torch.Tensor, *, power: float = 4.0,
                  decay: float = 0.5, use_trust: bool = False,
                  power_warmup_rounds: int = 2,
                  row_mask: Optional[torch.Tensor] = None,
                  client_mask: Optional[torch.Tensor] = None,
                  report_clip: Optional[float] = None) -> ScoreState:
    """One round of Algorithm 1 line 13 (see the reference docstring for
    the power warm-up and the ``client_mask`` freezing of non-sampled
    clients)."""
    acc = combine_tester_reports(
        acc_matrix, tester_ids,
        trust=state.tester_trust if use_trust else None,
        row_mask=row_mask, clip=report_clip)
    eff_power = torch.where(state.rounds_seen < power_warmup_rounds,
                            1.0, power)
    powered = torch.clamp(acc, 0.0, 1.0) ** eff_power
    new = torch.where(state.rounds_seen == 0, powered,
                      decay * state.scores + (1.0 - decay) * powered)
    if client_mask is not None:
        new = torch.where(client_mask > 0, new, state.scores)
    return state._replace(scores=new, rounds_seen=state.rounds_seen + 1)


def score_weights(state: ScoreState) -> torch.Tensor:
    """Aggregation weights (Algorithm 1 line 14)."""
    s = torch.clamp(state.scores, min=0.0)
    total = s.sum()
    n = s.shape[0]
    return torch.where(total > 1e-12, s / torch.clamp(total, min=1e-12),
                       torch.full_like(s, 1.0 / n))
