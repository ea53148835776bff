from repro_torch.optim.optimizer import Optimizer, make_optimizer
from repro_torch.optim.schedules import make_schedule

__all__ = ["Optimizer", "make_optimizer", "make_schedule"]
