"""Model configs (``repro.configs`` less the encdec and vlm families)
and the named federated scenarios.

Each model module defines ``config() -> ModelConfig`` with the values of
its reference twin; ``get_config(arch_id)`` resolves the CLI ``--arch``
id, ``get_scenario(name)`` a ``--scenario`` preset, and
``scenario_for_pod`` / ``scenario_for_population`` refit one.
"""
from repro_torch.configs.registry import ARCH_IDS, get_config, list_configs
from repro_torch.configs.scenarios import (
    SCENARIOS, get_scenario, list_scenarios, scenario_for_pod,
    scenario_for_population)

__all__ = ["ARCH_IDS", "SCENARIOS", "get_config", "get_scenario",
           "list_configs", "list_scenarios", "scenario_for_pod",
           "scenario_for_population"]
