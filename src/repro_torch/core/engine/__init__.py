"""The FedTest round engine of the port (counterpart of
``repro.core.engine``): one :class:`RoundProgram` owning steps 1-7, the
``local`` exchange backend, and the :class:`FederatedTrainer` driver."""
from repro_torch.core.engine.backends import LocalBackend
from repro_torch.core.engine.driver import (
    FederatedTrainer, RoundState, StateDict, resolve_device)
from repro_torch.core.engine.program import (
    RoundDraws, RoundProgram, aggregator_defaults, compose_fault_mask,
    flat_update_dim, init_comp_state, participation_mask,
    renormalize_over_subset, resolve_coalition, resolve_compressor,
    resolve_fault, resolve_strategies)

__all__ = [
    "FederatedTrainer", "LocalBackend", "RoundDraws", "RoundProgram",
    "RoundState", "StateDict", "aggregator_defaults", "compose_fault_mask",
    "flat_update_dim", "init_comp_state", "participation_mask",
    "renormalize_over_subset", "resolve_coalition", "resolve_compressor",
    "resolve_device", "resolve_fault", "resolve_strategies",
]
