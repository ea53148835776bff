from repro_torch.eval.metrics import classify_accuracy, evaluate_classifier

__all__ = ["classify_accuracy", "evaluate_classifier"]
