from repro_torch.config.base import FedConfig, ModelConfig, TrainConfig

__all__ = ["FedConfig", "ModelConfig", "TrainConfig"]
