"""The paper's model for MNIST-shaped inputs (Fig. 5 experiments)."""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="fedtest-cnn-mnist",
        family="cnn",
        num_layers=3,
        image_size=28,
        image_channels=1,
        cnn_channels=(32, 64, 64),
        cnn_hidden=128,
        num_classes=10,
        dtype="float32",
        source="FedTest paper Sec. IV (MNIST experiments)",
    )
