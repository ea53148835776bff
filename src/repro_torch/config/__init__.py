from repro_torch.config.base import (
    FedConfig, ModelConfig, TrainConfig, reduce_for_smoke)

__all__ = ["FedConfig", "ModelConfig", "TrainConfig", "reduce_for_smoke"]
