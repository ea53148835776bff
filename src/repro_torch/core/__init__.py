"""FedTest (Sec. III, Algorithm 1) in PyTorch: scoring, tester selection,
attacks, cross-testing and the round engine (counterpart of
``repro.core``)."""
from repro_torch.core.cross_testing import (
    cross_test_batched, cross_test_reference, make_eval_fn)
from repro_torch.core.engine import FederatedTrainer, RoundState
from repro_torch.core.scoring import (
    ScoreState, init_scores, score_weights, update_scores)
from repro_torch.core.selection import select_testers, pick_testers

__all__ = [
    "FederatedTrainer", "RoundState", "ScoreState",
    "cross_test_batched", "cross_test_reference",
    "init_scores", "make_eval_fn", "score_weights", "select_testers",
    "pick_testers", "update_scores",
]
