from repro_torch.roofline.hw import (
    CHIPS, Chip, H100_NVL, H100_PCIE, H100_SXM, H200, TPU_V5E, chip_for)
from repro_torch.roofline.analysis import (
    CostCounter, collective_bytes_per_device, model_flops, roofline_terms)

__all__ = ["CHIPS", "Chip", "CostCounter", "H100_NVL", "H100_PCIE",
           "H100_SXM", "H200", "TPU_V5E", "chip_for",
           "collective_bytes_per_device", "model_flops", "roofline_terms"]
