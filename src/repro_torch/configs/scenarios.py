"""Named federated scenarios (counterpart of ``repro/configs/scenarios.py``):
the reference's presets, each a full :class:`FedConfig` of the port.
``--scenario`` in ``repro_torch.launch.train`` resolves them by name, and
flags passed on the command line override single fields.
:func:`scenario_for_pod` refits a preset's client-count-dependent fields
to another federation size, and :func:`scenario_for_population` refits it
onto the population tier (a cohort of C clients sampled from N).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.config import FedConfig

SCENARIOS: Dict[str, FedConfig] = {
    # the paper's headline experiments (Sec. V / Fig. 4)
    "honest": FedConfig(
        num_users=20, num_testers=5, num_malicious=0, attack="none",
        rounds=60),
    "paper_random_weights": FedConfig(
        num_users=20, num_testers=5, num_malicious=3,
        attack="random_weights", rounds=60),
    "paper_lying_testers": FedConfig(
        num_users=20, num_testers=5, num_malicious=3,
        attack="random_weights", lying_testers=2, rounds=60),
    # robust-baseline comparisons opened by the strategy registry
    "krum_vs_scaled_update": FedConfig(
        num_users=20, num_testers=5, num_malicious=4,
        aggregator="krum", attack="scaled_update", attack_scale=10.0,
        rounds=60),
    "trimmed_mean_vs_label_flip": FedConfig(
        num_users=20, num_testers=5, num_malicious=4,
        aggregator="trimmed_mean", attack="label_flip_proxy", rounds=60),
    "median_vs_spread_attack": FedConfig(
        num_users=20, num_testers=5, num_malicious=4, aggregator="median",
        attack="random_weights", attack_kwargs={"placement": "spread"},
        rounds=60),
    "fixed_testers": FedConfig(
        num_users=20, num_testers=5, num_malicious=3,
        attack="random_weights", selector="fixed", rounds=60),
    # per-coordinate defences on the combine() fast path
    "coord_trimmed_mean_vs_scaled_update": FedConfig(
        num_users=20, num_testers=5, num_malicious=4,
        aggregator="trimmed_mean_coord",
        aggregator_kwargs={"trim_fraction": 0.25},
        attack="scaled_update", attack_scale=10.0, rounds=60),
    "coord_median_score_gated": FedConfig(
        num_users=20, num_testers=5, num_malicious=4,
        aggregator="median_coord", aggregator_kwargs={"score_gate": 0.2},
        attack="random_weights", rounds=60),
    # client sampling (participation R/N < 1, Sec. III notation)
    "partial_participation": FedConfig(
        num_users=20, num_testers=5, num_malicious=3,
        attack="random_weights", participation=0.5, rounds=60),
    # the combined adversarial + sampling setting every exchange backend
    # must agree on (the equivalence matrix's configuration,
    # EXPERIMENTS.md §Scenarios)
    "sign_flip_partial_participation": FedConfig(
        num_users=20, num_testers=5, num_malicious=1, attack="sign_flip",
        participation=0.75, rounds=60),
    # adaptive attacker reading its own weight through the AttackContext
    # seam: corrupts only while the federation still buys its update
    # (the ROADMAP's cross-testing-aware adversary, DESIGN.md §2)
    "adaptive_scale_vs_fedtest": FedConfig(
        num_users=20, num_testers=5, num_malicious=3,
        attack="adaptive_scale", attack_scale=4.0,
        attack_kwargs={"weight_threshold": 0.5}, rounds=60),
    # --- coalition adversaries (DESIGN.md §7) -------------------------
    # lying-tester coalition: members poison their models (independent
    # random_weights over the same slots) AND, whenever selected to
    # test, boost each other / defame the top-scoring honest clients.
    # Plain score averaging LOSES to this coalition (the boosts keep the
    # poison flowing and the defamation grinds the honest scores down);
    # the preset therefore runs the Sec. V-C tester-trust consensus with
    # a fast forgetting rate plus consensus-clipped reports, which bound
    # a member's report influence from round 1 (DESIGN.md §7).
    "mutual_boost_vs_fedtest": FedConfig(
        num_users=20, num_testers=5, num_malicious=4,
        attack="random_weights", coalition="mutual_boost",
        coalition_size=4,
        aggregator_kwargs={"use_trust": True, "trust_decay": 0.3,
                           "report_clip": 0.2},
        rounds=60),
    # sybil coalition splitting one scale-8 sign-flip poison so each
    # member's update stays at an inconspicuous scale-2 magnitude;
    # model-space only, so plain fedtest scoring suppresses it
    "sybil_split_vs_fedtest": FedConfig(
        num_users=20, num_testers=5, num_malicious=0, attack="none",
        coalition="sybil_split", coalition_size=4, attack_scale=8.0,
        rounds=60),
    # the combined worst case: split poisoning + mutual boosting
    "full_collusion_vs_fedtest": FedConfig(
        num_users=20, num_testers=5, num_malicious=0, attack="none",
        coalition="full_collusion", coalition_size=4, attack_scale=8.0,
        aggregator_kwargs={"use_trust": True, "trust_decay": 0.3,
                           "report_clip": 0.2},
        rounds=60),
    # --- compressed exchange variants (DESIGN.md §12) -----------------
    # the equivalence-matrix configuration over a quantised wire: does
    # the defence survive when every exchanged update round-trips
    # through int8 per-chunk quantisation with error feedback?
    "int8_sign_flip_partial_participation": FedConfig(
        num_users=20, num_testers=5, num_malicious=1, attack="sign_flip",
        participation=0.75, compressor="int8", rounds=60),
    # top-k sparsification (5% of coordinates per round) against the
    # lying-tester coalition — the sparsest wire the suppression claims
    # are committed for
    "topk_mutual_boost_vs_fedtest": FedConfig(
        num_users=20, num_testers=5, num_malicious=4,
        attack="random_weights", coalition="mutual_boost",
        coalition_size=4, compressor="topk",
        compressor_kwargs={"k": 0.05},
        aggregator_kwargs={"use_trust": True, "trust_decay": 0.3,
                           "report_clip": 0.2},
        rounds=60),
    # rank-4 delta factorisation under the adaptive attacker
    "lowrank_adaptive_scale": FedConfig(
        num_users=20, num_testers=5, num_malicious=3,
        attack="adaptive_scale", attack_scale=4.0,
        attack_kwargs={"weight_threshold": 0.5},
        compressor="lowrank", compressor_kwargs={"rank": 4}, rounds=60),
}


def get_scenario(name: str) -> FedConfig:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: "
                       f"{sorted(SCENARIOS)}")
    return SCENARIOS[name]


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def scenario_for_pod(name: str, num_clients: int) -> FedConfig:
    """A named preset refit to ``num_clients`` clients, as the reference
    refits it for a pod of that many ranks (a pure function of the
    preset; :func:`scenario_for_population` refits through it, and the
    pod CLI's ``--scenario``, ``repro_torch.launch.federated``, uses it).
    Testers and attackers are clamped to stay valid. A coalition refits by
    fraction (4 of 20 becomes 1 of 4, 2 of 8), floored at one member, and
    drags a paired attack of the same size along; every other field
    carries over (DESIGN.md §7)."""
    fed = get_scenario(name)
    num_mal = min(fed.num_malicious, max(num_clients - 1, 0))
    coal = 0
    ckw = dict(fed.coalition_kwargs)
    if fed.coalition != "none":
        # membership may come from coalition_size OR coalition_kwargs
        # (size= / indices=) — the same three forms FedConfig validates
        members = (fed.coalition_size or int(ckw.get("size") or 0)
                   or len(ckw.get("indices") or ()))
        coal = max(1, round(members * num_clients / fed.num_users))
        coal = min(coal, max(num_clients - 1, 0))
        # the refit owns membership: stale explicit size/indices from
        # the preset would override (or out-range) the refit placement
        ckw.pop("size", None)
        ckw.pop("indices", None)
        if fed.num_malicious == members:
            # the preset paired the independent attack with the
            # coalition over the same slots (equal sizes); keep them
            # paired after the refit, in both grow and shrink
            # directions. Unpaired attacks keep their own clamp.
            num_mal = coal
    return dataclasses.replace(
        fed, num_users=num_clients,
        num_testers=min(fed.num_testers, num_clients),
        num_malicious=num_mal,
        # a 1-client pod cannot hold a coalition (members < N): drop the
        # name with the members or FedConfig rejects the vacuous config
        coalition=fed.coalition if coal else "none",
        coalition_kwargs=ckw, coalition_size=coal)


def scenario_for_population(name: str, population: int, cohort: int
                            ) -> FedConfig:
    """A named preset refit onto the population tier (DESIGN.md §11):
    :func:`scenario_for_pod`'s refit to ``population`` clients, then the
    cohort capacity, with the Bernoulli sampling rate replaced by
    ``cohort / population`` so that the expected cohort fills the buffer
    (a preset's own partial participation is replaced, not composed: on
    this tier the rate is the cohort budget). Raises when ``cohort`` is
    outside ``[1, population]``."""
    if not 1 <= cohort <= population:
        raise ValueError(
            f"cohort={cohort} must be in [1, population={population}] — "
            "a cohort larger than the population gathers clients that "
            "do not exist")
    fed = scenario_for_pod(name, population)
    if cohort < population:
        return dataclasses.replace(fed, cohort=cohort,
                                   participation=cohort / population)
    return dataclasses.replace(fed, cohort=cohort)
