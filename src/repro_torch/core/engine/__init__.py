"""The FedTest round engine of the port (counterpart of
``repro.core.engine``): one :class:`RoundProgram` owning steps 1-7, the
``local`` exchange backend, the :class:`FederatedTrainer` driver, and
the population tier (:class:`PopulationTrainer` on the cohort-gather
:class:`PopulationBackend`)."""
from repro_torch.core.engine.backends import LocalBackend
from repro_torch.core.engine.driver import (
    FederatedTrainer, RoundState, StateDict, resolve_device)
from repro_torch.core.engine.program import (
    RoundDraws, RoundProgram, aggregator_defaults, compose_fault_mask,
    flat_update_dim, init_comp_state, participation_mask,
    renormalize_over_subset, resolve_coalition, resolve_compressor,
    resolve_fault, resolve_strategies, training_route_model)
from repro_torch.core.engine.population import (
    CohortModels, CohortPlan, PopulationBackend, PopulationTrainer,
    client_noise,
    cohort_from_mask, recruit_testers)

__all__ = [
    "CohortModels", "CohortPlan", "FederatedTrainer", "LocalBackend", "PopulationBackend",
    "PopulationTrainer", "RoundDraws", "RoundProgram", "RoundState",
    "StateDict", "aggregator_defaults", "client_noise", "cohort_from_mask",
    "compose_fault_mask", "recruit_testers",
    "flat_update_dim", "init_comp_state", "participation_mask",
    "renormalize_over_subset", "resolve_coalition", "resolve_compressor",
    "resolve_device", "resolve_fault", "resolve_strategies",
    "training_route_model",
]
