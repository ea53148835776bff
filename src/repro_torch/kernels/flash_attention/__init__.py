from repro_torch.kernels.flash_attention.ops import (
    blockwise_attention, flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_ref", "blockwise_attention", "flash_attention"]
