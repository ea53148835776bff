"""The port's adversary surface against the reference: faults, lying
testers, coalitions, ``scaled_collusion`` and the scenario presets.

* the fault masks from the reference's ``keys.fault`` draws, and
  ``compose_fault_mask`` with its fallback: equal exactly;
* ``scaled_collusion``, ``mutual_boost``'s masked-matrix transform (ties
  in the scores included) and the composed attack's union of malicious
  sets, on inputs made with numpy: equal exactly, floats at 1e-6;
* one round under each fault, the liars and each coalition, the port
  replaying the reference's draws: the ``[K, N]`` counts and
  ``dropped_fraction`` equal, weights, scores and params at rtol=1e-4,
  atol=1e-5 (as ``tests/test_torch_round.py`` holds the paper's round);
* every preset equal to the reference's field for field, refit by
  ``scenario_for_pod`` at 2, 4 and 8 clients, and one round of each in
  the port at 4 clients.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.configs import scenarios as jscenarios  # noqa: E402
from repro.core.engine import program as jprogram  # noqa: E402
from repro.core.engine import round_keys  # noqa: E402
from repro.strategies import ATTACKS as JATTACKS  # noqa: E402
from repro.strategies import COALITIONS as JCOALITIONS  # noqa: E402
from repro.strategies.base import AttackContext as JAttackContext  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    SCENARIOS, get_config, get_scenario, list_scenarios, scenario_for_pod)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    compose_fault_mask, resolve_coalition, resolve_fault,
    resolve_strategies)
from repro_torch.data import MNIST_LIKE, make_federated_image_dataset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.strategies import ATTACKS, COALITIONS  # noqa: E402
from repro_torch.strategies.base import AttackContext  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_round import (  # noqa: E402
    FAULT_DRAWS, _assert_counts_match, _assert_round_matches, _replay)

FN = 20     # clients of the pure-function cases


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ------------------------------------------------------------------ faults
FAULTS_CASES = {
    "dropout": ("dropout", {}, 0.3),
    "dropout_high": ("dropout", {}, 0.8),
    "straggler": ("straggler_deadline", {}, 0.1),
    "straggler_tight": ("straggler_deadline",
                        {"deadline": 1.2, "spread": 2.0}, 0.1),
    "targeted": ("targeted", {"size": 3}, 0.1),
    "targeted_late": ("targeted", {"indices": (1, 7), "start_round": 2},
                      0.1),
    "targeted_spread": ("targeted", {"size": 4, "placement": "spread"},
                        0.1),
}


@pytest.mark.parametrize("case", list(FAULTS_CASES))
def test_fault_masks_match_reference_draws(case):
    """The port's pure mask of the reference's ``keys.fault`` draws is the
    reference's mask, for three rounds."""
    name, kw, rate = FAULTS_CASES[case]
    fed = dict(num_users=FN, fault=name, fault_kwargs=kw, fault_rate=rate)
    jfault = jprogram.resolve_fault(JFedConfig(**fed))
    fault = resolve_fault(FedConfig(**fed))
    assert type(fault).__name__ == type(jfault).__name__
    for r in range(3):
        keys = round_keys(jax.random.fold_in(jax.random.PRNGKey(7), r))
        want = np.asarray(jfault.mask(keys.fault, FN, jnp.asarray(r)))
        draws = FAULT_DRAWS[name](keys.fault, FN)
        got = fault.mask(None if draws is None else _t(draws), FN, r)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["dropout", "straggler_deadline"])
def test_fault_draws_come_from_the_round_generator(name):
    fault = resolve_fault(FedConfig(num_users=FN, fault=name))
    gen = torch.Generator().manual_seed(3)
    one = fault.draw(gen, FN)
    two = fault.draw(torch.Generator().manual_seed(3), FN)
    assert one.shape == (FN,) and torch.equal(one, two)
    assert not torch.equal(one, fault.draw(gen, FN))


@pytest.mark.parametrize("part,alive", [
    ([1, 1, 1, 1, 1, 1], [1, 0, 1, 0, 1, 1]),
    ([1, 0, 1, 1, 0, 1], [0, 1, 1, 0, 1, 1]),
    ([1, 0, 1, 1, 0, 1], [0, 1, 0, 0, 1, 0]),     # all selected dropped
    ([1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0]),
])
def test_compose_fault_mask_matches_reference(part, alive):
    part = np.asarray(part, np.float32)
    alive = np.asarray(alive, np.float32)
    want = np.asarray(jprogram.compose_fault_mask(jnp.asarray(part),
                                                  jnp.asarray(alive)))
    got = compose_fault_mask(_t(part), _t(alive)).numpy()
    np.testing.assert_array_equal(got, want)
    if (part * alive).sum() == 0:
        # the fallback ignores the faults for the round
        np.testing.assert_array_equal(got, part)


# --------------------------------------------------------- model attacks
def _j_composed(jfed, n):
    """The reference's attack seam: the attack composed with the
    coalition, as its RoundProgram builds it."""
    atk = jprogram.resolve_strategies(jfed)[1]
    return jprogram.resolve_coalition(jfed).compose(atk, n)


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (3, 4), "b": (4,)}, "c": (5,)}

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return rng.standard_normal((FN,) + node).astype(np.float32)
    stacked = make(shapes)
    glob = jax.tree_util.tree_map(lambda a: a[0] * 0.5, stacked)
    return stacked, glob


def _ttree(tree):
    return jax.tree_util.tree_map(lambda a: _t(a), tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("kw", [dict(num_malicious=4, scale=8.0),
                                dict(num_malicious=3, scale=6.0, split=2),
                                dict(indices=(0, 9), scale=2.5)])
def test_scaled_collusion_matches_reference(kw):
    stacked, glob = _trees(0)
    jatk = JATTACKS.build("scaled_collusion", kw)
    atk = ATTACKS.build("scaled_collusion", kw)
    assert atk.split == jatk.split
    want = jatk.apply(jax.random.PRNGKey(0), _jtree(stacked), _jtree(glob))
    got = atk.apply(None, _ttree(stacked), _ttree(glob))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("coalition,base", [
    ("sybil_split", dict(attack="sign_flip", num_malicious=3)),
    ("full_collusion", dict(attack="scaled_update", num_malicious=2,
                            attack_kwargs={"placement": "first"})),
    ("mutual_boost", dict(attack="sign_flip", num_malicious=5)),
])
def test_composed_attack_unions_the_malicious_sets(coalition, base):
    """Members join the malicious set; the coalition's model attack wins
    on members, the base attack acts on its own clients."""
    fed = dict(num_users=FN, coalition=coalition, coalition_size=4,
               coalition_kwargs={"placement": "spread"}, attack_scale=4.0,
               **base)
    jatk = _j_composed(JFedConfig(**fed), FN)
    pfed = FedConfig(**fed)
    base_atk = resolve_strategies(pfed)[1]
    coal = resolve_coalition(pfed)
    atk = coal.compose(base_atk, FN)
    union = set(coal.members(FN)) | set(base_atk.malicious_indices(FN))
    assert atk.malicious_indices(FN) == jatk.malicious_indices(FN) \
        == tuple(sorted(union))
    np.testing.assert_array_equal(atk.malicious_mask(FN).numpy(),
                                  np.asarray(jatk.malicious_mask(FN)))
    stacked, glob = _trees(1)
    want = jatk.apply(jax.random.PRNGKey(0), _jtree(stacked), _jtree(glob))
    got = atk.apply(None, _ttree(stacked), _ttree(glob))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------- report transform
@pytest.mark.parametrize("kw", [
    dict(size=4),
    dict(size=4, deflate_top=0),
    dict(size=3, deflate_top=2, boost_to=0.9, deflate_to=0.1,
         placement="first"),
    dict(indices=(2, 11, 17), deflate_top=19),
])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("name", ["mutual_boost", "full_collusion"])
def test_mutual_boost_transform_matches_reference(kw, tied, name):
    """The masked-matrix equation on a [K, N] matrix; ``tied`` scores are
    round 0's zeros, where the defamed set is the lowest honest ids."""
    rng = np.random.default_rng(len(kw) + 3 * tied)
    k = 6
    acc = rng.uniform(size=(k, FN)).astype(np.float32)
    ids = rng.choice(FN, size=k, replace=False).astype(np.int32)
    scores = (np.zeros(FN, np.float32) if tied
              else rng.uniform(size=FN).astype(np.float32))
    jc = JCOALITIONS.build(name, kw)
    c = COALITIONS.build(name, kw)
    ids[0] = c.members(FN)[0]                           # a member tests
    jctx = JAttackContext(jnp.asarray(scores), jnp.asarray(scores),
                          jnp.asarray(0))
    ctx = AttackContext(_t(scores), _t(scores), 0)
    want = np.asarray(jc.transform_reports(jax.random.PRNGKey(0),
                                           jnp.asarray(acc),
                                           jnp.asarray(ids), jctx))
    got = c.transform_reports(None, _t(acc), _t(ids), ctx).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, acc)


# ------------------------------------------------------- replayed rounds
# one round of the quickstart-sized config per case, the port on the
# reference's draws (tests/test_torch_round.py's _replay). Fixed testers
# (0, 5) keep a liar (id 0) and a member (5) on the committee
FIXED = dict(selector="fixed", selector_kwargs={"indices": (0, 5)})
TRUST = {"use_trust": True, "trust_decay": 0.3, "report_clip": 0.2}
ROUND_CASES = {
    "dropout": dict(fed_extra=dict(fault="dropout", fault_rate=0.4)),
    "straggler_deadline": dict(fed_extra=dict(fault="straggler_deadline",
                                              fault_kwargs={"deadline": 1.5})),
    "targeted": dict(fed_extra=dict(fault="targeted",
                                    fault_kwargs={"size": 2})),
    "lying_testers": dict(fed_extra=dict(lying_testers=1, **FIXED)),
    "mutual_boost": dict(aggregator_kwargs=TRUST, fed_extra=dict(
        coalition="mutual_boost", coalition_size=2, **FIXED)),
    "sybil_split": dict(attack="none", fed_extra=dict(
        coalition="sybil_split", coalition_size=2, attack_scale=8.0)),
    "full_collusion": dict(attack="none", aggregator_kwargs=TRUST,
                           fed_extra=dict(coalition="full_collusion",
                                          coalition_size=2, fault="dropout",
                                          fault_rate=0.3, attack_scale=8.0,
                                          lying_testers=1, **FIXED)),
}


@pytest.fixture(scope="module", params=list(ROUND_CASES))
def adversary_round(request):
    return request.param, _replay(entering_state=True,
                                  **ROUND_CASES[request.param])


def test_adversary_round_accuracy_counts_match_exactly(adversary_round):
    _assert_counts_match(adversary_round[1])


def test_adversary_round_matches_reference(adversary_round):
    name, r = adversary_round
    _assert_round_matches(r)
    got = float(r["tmetrics"]["dropped_fraction"])
    assert got == float(r["jmetrics"]["dropped_fraction"])
    w = r["tmetrics"]["weights"].numpy()
    if name in ("dropout", "straggler_deadline", "targeted",
                "full_collusion"):
        # a dropped client is paid nothing
        assert got > 0.0 or name == "full_collusion"
        assert (w[r["part_mask"] == 0] == 0).all()
    if name == "targeted":
        assert got == pytest.approx(2 / 6) and (w[4:] == 0).all()


# ------------------------------------------------------------ the presets
def test_the_presets_are_the_references():
    assert list_scenarios() == jscenarios.list_scenarios()
    assert len(SCENARIOS) == 18


@pytest.mark.parametrize("name", sorted(jscenarios.SCENARIOS))
def test_preset_fields_and_pod_refits_match_reference(name):
    assert dataclasses.asdict(get_scenario(name)) == dataclasses.asdict(
        jscenarios.get_scenario(name))
    for clients in (2, 4, 8):
        assert dataclasses.asdict(scenario_for_pod(name, clients)) == \
            dataclasses.asdict(jscenarios.scenario_for_pod(name, clients))


@pytest.fixture(scope="module")
def tiny():
    model = build_model(get_config("fedtest-mlp-mnist").replace(
        mlp_hidden=(16,)))
    data = make_federated_image_dataset(MNIST_LIKE, 4, num_samples=400,
                                        global_test=50, seed=0,
                                        device="cpu")
    tc = TrainConfig(optimizer="sgd", lr=0.1, schedule="constant",
                     batch_size=8, grad_clip=0.0)
    return model, data, tc


@pytest.mark.parametrize("name", sorted(jscenarios.SCENARIOS))
def test_every_preset_runs_a_round_in_the_port(name, tiny):
    model, data, tc = tiny
    fed = dataclasses.replace(scenario_for_pod(name, 4), local_steps=1)
    trainer = FederatedTrainer(model, fed, tc, eval_batch=16, device="cpu")
    state, metrics = trainer.run_round(trainer.init(), data)
    w = metrics["weights"]
    assert state.round_idx == 1 and w.shape == (4,)
    np.testing.assert_allclose(float(w.sum()), 1.0, atol=1e-5)
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(state.global_params))
    assert trainer.attack.malicious_indices(4) == _j_composed(
        jscenarios.scenario_for_pod(name, 4), 4).malicious_indices(4)


def test_cli_scenario_flags_override_single_fields():
    """``--scenario`` is the preset with every flag passed explicitly in
    its place; a flag not passed leaves the preset's field, and the CLI's
    own defaults are the reference's."""
    from repro.launch import train as jtrain
    from repro_torch.launch.train import (
        _FED_CLI_DEFAULTS, fed_config, parse_args)
    assert _FED_CLI_DEFAULTS == jtrain._FED_CLI_DEFAULTS
    fed = fed_config(parse_args(["--scenario", "mutual_boost_vs_fedtest",
                                 "--users", "8", "--fault", "dropout",
                                 "--fault-rate", "0.2"]))
    assert fed == dataclasses.replace(
        get_scenario("mutual_boost_vs_fedtest"), num_users=8,
        fault="dropout", fault_rate=0.2)
    assert fed_config(parse_args([])) == FedConfig(**_FED_CLI_DEFAULTS)


def test_chip_smoke_paths_e_and_f_take_their_presets():
    """Paths E and F of ``chip_smoke.py`` run on the presets: their run
    flags override no FedConfig field but ``rounds``, ``local_steps``
    (path A's 10) and E's fault."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.launch.train import fed_config, parse_args
    rounds = dict(rounds=chip_smoke.ROUNDS, local_steps=10)
    assert fed_config(parse_args(chip_smoke.E_ARGS)) == dataclasses.replace(
        get_scenario("full_collusion_vs_fedtest"),
        fault="straggler_deadline", **rounds)
    assert fed_config(parse_args(chip_smoke.F_ARGS)) == dataclasses.replace(
        get_scenario("paper_lying_testers"), **rounds)
    main = fed_config(parse_args(chip_smoke.MAIN_PATH_ARGS))
    assert (main.num_users, main.num_testers, main.num_malicious,
            main.attack, main.coalition, main.fault, main.lying_testers) \
        == (20, 5, 3, "random_weights", "none", "none", 0)
