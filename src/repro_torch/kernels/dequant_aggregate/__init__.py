from repro_torch.kernels.dequant_aggregate.ops import dequant_aggregate
from repro_torch.kernels.dequant_aggregate.ref import dequant_aggregate_ref

__all__ = ["dequant_aggregate", "dequant_aggregate_ref"]
