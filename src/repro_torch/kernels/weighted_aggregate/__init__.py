from repro_torch.kernels.weighted_aggregate.ops import (
    TABLE, THREADS, Launch, aggregate_pytree, plan_launches,
    weighted_aggregate)
from repro_torch.kernels.weighted_aggregate.ref import weighted_aggregate_ref

__all__ = ["Launch", "TABLE", "THREADS", "aggregate_pytree", "plan_launches",
           "weighted_aggregate", "weighted_aggregate_ref"]
