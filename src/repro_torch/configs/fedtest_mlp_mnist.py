"""The paper's MNIST fully-connected classifier (Fig. 4 experiments)."""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="fedtest-mlp-mnist",
        family="mlp",
        num_layers=2,
        image_size=28,
        image_channels=1,
        mlp_hidden=(200, 200),
        num_classes=10,
        dtype="float32",
        source="FedTest paper Sec. IV (MNIST experiments)",
    )
