"""Compatibility shim, the counterpart of ``repro/core/distributed.py``:
the pod round lives in :mod:`repro_torch.core.engine` (the ring and
all-gather exchanges are
:class:`~repro_torch.core.engine.backends.RingBackend` and
:class:`~repro_torch.core.engine.backends.AllgatherBackend`, driving the
one shared :class:`~repro_torch.core.engine.program.RoundProgram`); this
module keeps the reference's import surface for the pod round builders.
"""
from repro_torch.core.engine.backends import (
    make_allgather_round, make_distributed_round, make_pod_round,
    ring_cross_test)

__all__ = [
    "make_allgather_round", "make_distributed_round", "make_pod_round",
    "ring_cross_test",
]
