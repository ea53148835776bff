"""The paper's own model (Sec. III): 3 conv layers + 2 FC + softmax, for
CIFAR-10-shaped inputs (188,810 params)."""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="fedtest-cnn",
        family="cnn",
        num_layers=3,
        image_size=32,
        image_channels=3,
        cnn_channels=(32, 64, 64),
        cnn_hidden=128,
        num_classes=10,
        dtype="float32",
        source="FedTest paper Sec. III (3 conv + 2 FC, CIFAR-10)",
    )
