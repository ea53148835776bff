from repro_torch.config.base import (
    LM_FAMILIES, ROUND_LM_FAMILIES, FedConfig, ModelConfig, TrainConfig,
    reduce_for_smoke)

__all__ = ["LM_FAMILIES", "ROUND_LM_FAMILIES", "FedConfig", "ModelConfig",
           "TrainConfig", "reduce_for_smoke"]
