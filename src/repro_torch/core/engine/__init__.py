"""The FedTest round engine of the port (counterpart of
``repro.core.engine``): one :class:`RoundProgram` owning steps 1-7, the
``local`` exchange backend and its :class:`FederatedTrainer` driver, the
pod's ``ring`` and ``allgather`` backends (one client a rank of a
``torch.distributed`` group; :func:`make_pod_round` and
:class:`PodTrainer`), and the population tier (:class:`PopulationTrainer`
on the cohort-gather :class:`PopulationBackend`, its cohort optionally
sharded over a group's ranks)."""
from repro_torch.core.engine.backends import (
    AllgatherBackend, LocalBackend, PodBackend, RingBackend,
    make_allgather_round, make_distributed_round, make_pod_round,
    ring_cross_test)
from repro_torch.core.engine.driver import (
    FederatedTrainer, PodTrainer, RoundState, StateDict, resolve_device)
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
    "AllgatherBackend", "CohortModels", "CohortPlan", "FederatedTrainer",
    "LocalBackend", "PodBackend", "PodTrainer", "PopulationBackend",
    "PopulationTrainer", "RingBackend", "RoundDraws", "RoundProgram", "RoundState",
    "StateDict", "aggregator_defaults", "client_noise", "cohort_from_mask",
    "compose_fault_mask", "recruit_testers",
    "flat_update_dim", "init_comp_state", "make_allgather_round",
    "make_distributed_round", "make_pod_round", "participation_mask",
    "renormalize_over_subset", "resolve_coalition", "resolve_compressor",
    "resolve_device", "resolve_fault", "resolve_strategies",
    "ring_cross_test",
    "training_route_model",
]
