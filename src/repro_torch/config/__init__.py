from repro_torch.config.base import (
    INPUT_SHAPES, LM_FAMILIES, ROUND_LM_FAMILIES, FedConfig, InputShape,
    MeshConfig, ModelConfig, TrainConfig, reduce_for_smoke)

__all__ = ["INPUT_SHAPES", "LM_FAMILIES", "ROUND_LM_FAMILIES", "FedConfig",
           "InputShape", "MeshConfig", "ModelConfig", "TrainConfig",
           "reduce_for_smoke"]
