from repro_torch.kernels.weighted_aggregate.ops import (
    aggregate_pytree, weighted_aggregate)
from repro_torch.kernels.weighted_aggregate.ref import weighted_aggregate_ref

__all__ = ["aggregate_pytree", "weighted_aggregate", "weighted_aggregate_ref"]
