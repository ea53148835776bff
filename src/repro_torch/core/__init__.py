"""FedTest (Sec. III, Algorithm 1) in PyTorch: scoring, tester selection,
attacks, cross-testing, aggregation and the round engine (counterpart of
``repro.core``)."""
from repro_torch.core.aggregation import (
    accuracy_based_weights, aggregate_models, fedavg_weights)
from repro_torch.core.attacks import apply_attacks
from repro_torch.core.cross_testing import (
    CROSSTEST_IMPLS, cross_test_accuracies, cross_test_batched,
    cross_test_reference, make_eval_fn)
from repro_torch.core.engine import FederatedTrainer, RoundState
from repro_torch.core.scoring import (
    ScoreState, init_scores, score_weights, update_scores)
from repro_torch.core.selection import select_testers, pick_testers

__all__ = [
    "CROSSTEST_IMPLS", "FederatedTrainer", "RoundState", "ScoreState",
    "accuracy_based_weights", "aggregate_models", "apply_attacks",
    "cross_test_accuracies",
    "cross_test_batched", "cross_test_reference", "fedavg_weights",
    "init_scores", "make_eval_fn", "score_weights", "select_testers",
    "pick_testers", "update_scores",
]
