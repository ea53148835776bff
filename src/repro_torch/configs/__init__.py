"""Model configs: the cnn/mlp, dense and ssm subset of ``repro.configs``.

Each module defines ``config() -> ModelConfig`` with the values of its
reference twin; ``get_config(arch_id)`` resolves the CLI ``--arch`` id.
"""
from repro_torch.configs.registry import ARCH_IDS, get_config, list_configs

__all__ = ["ARCH_IDS", "get_config", "list_configs"]
