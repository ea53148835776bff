"""The port's population tier (DESIGN.md §11) against the port's dense
engine and against the reference.

Within the port (small ``fedtest-cnn-mnist`` / ``fedtest-mlp-mnist``,
N <= 16, C <= 8, on the CPU):

* ``PopulationTrainer`` on ``DensePopulationData`` against
  ``FederatedTrainer`` over 3 rounds: the cohort plan, tester ids, the
  ``[K, N]`` accuracy counts and which weights are zero exactly; params,
  scores, weights, the malicious weight, the loss and the matrix mean
  bitwise where they agree, else within rtol 1e-6, atol 1e-7 (a vmap over
  C rows and one over N may round the last bits apart);
* ``cross_test_tiled`` equals the untiled call bitwise for every block;
* int8 on the cohort leaves every other client's error feedback bitwise
  and decodes nothing for masked and sentinel slots;
* a population run resumes bitwise from a checkpoint;
* ``SyntheticPopulation`` draws a client's shard from its id alone
  (keyed Philox counters), whichever cohort or slot gathers it; a row
  does not depend on how many rows are drawn; the train, test and
  global streams are disjoint; labels are in range and near uniform; a
  gather of 100,000 ids reads nothing to the host; a gather past
  ``SHARD_SLICE`` goes in blocks, equal to one pass; it builds nothing of
  size N x image; a draw at N = 100,000 with 20,000 attackers holds
  noise for at most C clients;
* every refusal, and the CLI on the CPU.

Against the reference: ``cohort_from_mask``, the tester remap,
``cross_test_tiled``'s counts and ``scenario_for_population`` exactly; one
population round on the reference's replayed draws (the ``[K, N]`` counts
exact, params and scores at rtol 1e-4, atol 1e-5), also from a reference
population checkpoint converted into the port.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import (  # noqa: E402
    CheckpointManager as JCheckpointManager)
from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import scenarios as jscenarios  # noqa: E402
from repro.core.cross_testing import (  # noqa: E402
    cross_test_tiled as j_cross_test_tiled, make_eval_fn as j_make_eval_fn)
from repro.core.engine import round_keys  # noqa: E402
from repro.core.engine.population import (  # noqa: E402
    PopulationTrainer as JPopulationTrainer,
    cohort_from_mask as j_cohort_from_mask)
from repro.data import MNIST_LIKE as J_MNIST  # noqa: E402
from repro.data import make_federated_image_dataset as jmake_data  # noqa: E402
from repro.data.population import (  # noqa: E402
    DensePopulationData as JDensePopulationData)
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    get_config, scenario_for_population)
from repro_torch.convert import (  # noqa: E402
    params_from_reference, state_from_reference_checkpoint)
from repro_torch.core.cross_testing import (  # noqa: E402
    cross_test_tiled, make_eval_fn)
from repro_torch.core.engine import (  # noqa: E402
    CohortPlan, FederatedTrainer, PopulationBackend, PopulationTrainer,
    RoundDraws, RoundState, cohort_from_mask, recruit_testers)
from repro_torch.core.engine.population import (  # noqa: E402
    KeyedNoise, RecordedNoise, client_noise, noise_key)
from repro_torch.core.scoring import init_scores  # noqa: E402
from repro_torch.data import (  # noqa: E402
    MNIST_LIKE, DensePopulationData, make_federated_image_dataset,
    make_synthetic_population)
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from test_torch_population_chunk import NoHostRead  # noqa: E402
from test_torch_round import _Recorder, _client_noise, _t  # noqa: E402

N = 8
RTOL, ATOL = 1e-4, 1e-5          # the port against the reference
OWN = dict(rtol=1e-6, atol=1e-7)  # the population tier against the dense
CNN = dict(cnn_channels=(4, 8, 8), cnn_hidden=16)
MLP = dict(mlp_hidden=(16,))
TC = dict(optimizer="sgd", lr=0.1, schedule="constant", batch_size=8,
          grad_clip=0.0)


@pytest.fixture(scope="module")
def setup():
    model = build_model(get_config("fedtest-cnn-mnist").replace(**CNN))
    data = make_federated_image_dataset(MNIST_LIKE, N, num_samples=800,
                                        global_test=200, seed=0,
                                        device="cpu")
    return model, data, TrainConfig(**TC)


@pytest.fixture(scope="module")
def mlp():
    return build_model(get_config("fedtest-mlp-mnist").replace(**MLP))


def _masks(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n,)) < 0.5).astype(np.float32)


# ------------------------------------------------------------ cohort plan
@pytest.mark.parametrize("mask,capacity", [
    ([1, 0, 1, 1, 0, 0, 1, 0], 6),          # fits: sentinel padding
    ([1, 1, 0, 1, 1, 1], 3),                # oversubscribed: truncated
    ([1] * 8, 8),                           # everyone
    ([1] * 8, 5),                           # everyone, truncated
    ([0] * 5, 3),                           # nobody
    (_masks(16, 0), 8), (_masks(16, 1), 4), (_masks(13, 2), 13),
])
def test_cohort_from_mask_matches_reference(mask, capacity):
    mask = np.asarray(mask, np.float32)
    want = j_cohort_from_mask(jnp.asarray(mask), capacity)
    got = cohort_from_mask(_t(mask), capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.float32
    if mask.sum() <= capacity:
        assert torch.equal(got[2], _t(mask))


@pytest.mark.parametrize("seed", range(4))
def test_testers_from_cohort_match_the_reference_remap(seed):
    rng = np.random.default_rng(seed)
    n, cap, k = 16, 6, 4
    mask = (rng.uniform(size=(n,)) < [0.0, 0.2, 0.5, 0.9][seed]
            ).astype(np.float32)
    idx, valid, _ = j_cohort_from_mask(jnp.asarray(mask), cap)
    tester_ids = jnp.asarray(rng.choice(n, k, replace=False), jnp.int32)
    pop_count = jnp.maximum(jnp.sum(valid).astype(jnp.int32), 1)
    want = np.asarray(jnp.minimum(idx[tester_ids % pop_count], n - 1))
    count = int(np.asarray(valid).sum())
    got = recruit_testers(_t(tester_ids), _t(idx).long(), _t(valid), n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    if count:
        assert set(got.tolist()) <= set(np.asarray(idx)[:count].tolist())


# ----------------------------------------------------- tiled cross-testing
def _ref_stack(cfg_name, replace, c, seed):
    jmodel = jbuild_model(jget_config(cfg_name).replace(**replace))
    keys = jax.random.split(jax.random.PRNGKey(seed), c)
    return jmodel, jax.vmap(jmodel.init)(keys)


def test_tiled_cross_test_counts_match_reference(mlp):
    jmodel, jstack = _ref_stack("fedtest-mlp-mnist", MLP, 7, 0)
    data = make_federated_image_dataset(MNIST_LIKE, 3, num_samples=600,
                                        global_test=10, seed=1,
                                        device="cpu")
    tx, ty = data.test.xs[:, :32], data.test.ys[:, :32]
    want = j_cross_test_tiled(j_make_eval_fn(jmodel), jstack,
                              jnp.asarray(tx.numpy()),
                              jnp.asarray(ty.numpy()), block=3)
    stack = tree_map(lambda a: torch.as_tensor(np.array(a)),
                     jax.tree_util.tree_map(np.asarray, jstack))
    got = cross_test_tiled(make_eval_fn(mlp), stack, tx, ty, block=3)
    np.testing.assert_array_equal((got * 32).round().numpy(),
                                  np.round(np.asarray(want) * 32))


@pytest.mark.parametrize("block", [1, 3, 6, 7, 0, 16])
def test_tiled_cross_test_is_bitwise_the_untiled(setup, block):
    model, data, _ = setup
    c = 7
    gen = torch.Generator().manual_seed(3)
    models = [model.init(gen) for _ in range(c)]
    stack = tree_map(lambda *xs: torch.stack(xs), *models)
    tx, ty = data.test.xs[:3, :24], data.test.ys[:3, :24]
    eval_fn = make_eval_fn(model)
    untiled = cross_test_tiled(eval_fn, stack, tx, ty, block=0)
    assert untiled.shape == (3, c)
    assert torch.equal(cross_test_tiled(eval_fn, stack, tx, ty,
                                        block=block), untiled)


# -------------------------------------------- scenario_for_population
@pytest.mark.parametrize("name", sorted(jscenarios.SCENARIOS))
def test_scenario_for_population_matches_reference(name):
    for population, cohort in ((64, 8), (4096, 32)):
        assert dataclasses.asdict(scenario_for_population(
            name, population, cohort)) == dataclasses.asdict(
                jscenarios.scenario_for_population(name, population,
                                                   cohort))


@pytest.mark.parametrize("population,cohort", [(4, 8), (4, 0), (64, 65)])
def test_scenario_for_population_refuses_a_cohort_outside_it(population,
                                                             cohort):
    with pytest.raises(ValueError, match="cohort"):
        jscenarios.scenario_for_population("honest", population, cohort)
    with pytest.raises(ValueError, match="cohort"):
        scenario_for_population("honest", population, cohort)


# ------------------------------------------- the population tier vs dense
class _Acc:
    """Wraps a backend's cross_test to keep the [K, N] matrix."""

    def __init__(self, backend):
        self.backend, self.acc = backend, None

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def cross_test(self, *args):
        self.acc = self.backend.cross_test(*args)
        return self.acc


def _close(name, got, want):
    """Bitwise where they agree, else within OWN; returns whether they
    were bitwise."""
    if torch.equal(got, want):
        return True
    torch.testing.assert_close(got, want, **OWN, msg=name)
    return False


def _hold_to_dense(tag, sd, md, sp, mp, dacc, pacc, ddraws, pdraws):
    n = md["weights"].shape[0]
    # discrete: testers, the honoured mask, the cohort plan, the counts
    # and which weights are zero
    assert torch.equal(ddraws.tester_ids, pdraws.tester_ids), tag
    assert torch.equal(ddraws.part_mask, pdraws.part_mask), tag
    ids = tuple(i for i in range(n) if ddraws.part_mask[i] > 0)
    assert pdraws.cohort.ids == ids, tag
    assert torch.equal((dacc * 32).round(), (pacc * 32).round()), tag
    assert torch.equal(md["weights"] == 0, mp["weights"] == 0), tag
    assert (mp["weights"][[i for i in range(n) if i not in ids]] == 0).all()
    bitwise = {}
    pairs = [("params/" + str(i), a, b) for i, (a, b) in enumerate(zip(
        tree_leaves(sd.global_params), tree_leaves(sp.global_params)))]
    pairs += [("scores." + f, getattr(sd.scores, f), getattr(sp.scores, f))
              for f in sd.scores._fields]
    pairs += [(k, md[k], mp[k]) for k in (
        "weights", "malicious_weight", "local_loss", "acc_matrix_mean")]
    for name, a, b in pairs:
        bitwise[name.split("/")[0]] = (bitwise.get(name.split("/")[0], True)
                                       and _close(f"{tag} {name}", b, a))
    return bitwise


def _pair(setup, **fed):
    model, _, tc = setup
    fed = FedConfig(num_users=N, num_testers=3, local_steps=2, **fed)
    dense = FederatedTrainer(model, fed, tc, eval_batch=32, device="cpu")
    pop = PopulationTrainer(model, fed, tc, eval_batch=32, device="cpu")
    dense.backend, pop.backend = _Acc(dense.backend), _Acc(pop.backend)
    return dense, pop


CASES = {
    "no_attack": dict(attack="none"),
    "sign_flip": dict(attack="sign_flip", num_malicious=2),
    # noise-free under the coalition too, so both engines draw one stream
    "mutual_boost": dict(attack="sign_flip", num_malicious=2,
                         coalition="mutual_boost", coalition_size=2,
                         aggregator_kwargs={"use_trust": True,
                                            "trust_decay": 0.3,
                                            "report_clip": 0.2}),
}
# the fields seen off bitwise in some round of the matrix; any other field
# off bitwise fails the test
MAY_DIFFER = {"params", "local_loss"}


@pytest.mark.parametrize("participation", [0.5, 0.75])
@pytest.mark.parametrize("case", sorted(CASES))
def test_population_tier_matches_the_dense_engine(setup, case,
                                                  participation):
    dense, pop = _pair(setup, participation=participation, cohort=N,
                       **CASES[case])
    data = setup[1]
    pd = DensePopulationData(data)
    sd, sp = dense.init(42), pop.init(42)
    for r in range(3):
        ddraws, pdraws = dense.draw(sd, data), pop.draw(sp, pd)
        idx, _, _ = cohort_from_mask(pdraws.part_mask, N)
        assert torch.equal(pdraws.batch_idx,
                           ddraws.batch_idx[idx.clamp(max=N - 1)])
        sd, md = dense.run_round(sd, data, draws=ddraws)
        sp, mp = pop.run_round(sp, pd, draws=pdraws)
        assert torch.equal(sd.gen.get_state(), sp.gen.get_state())
        bitwise = _hold_to_dense(f"{case} p={participation} round {r}",
                                 sd, md, sp, mp, dense.backend.acc,
                                 pop.backend.acc, ddraws, pdraws)
        off = {k for k, v in bitwise.items() if not v}
        assert off <= MAY_DIFFER, off


def test_random_weights_matches_dense_on_one_noise_record(setup):
    dense, pop = _pair(setup, participation=0.5, cohort=N,
                       attack="random_weights", num_malicious=3)
    data = setup[1]
    pd = DensePopulationData(data)
    sd, sp = dense.init(5), pop.init(5)
    ddraws, pdraws = dense.draw(sd, data), pop.draw(sp, pd)
    cohort_bad = [c for c in pdraws.cohort.ids if c in (5, 6, 7)]
    assert cohort_bad and pdraws.noise == KeyedNoise(noise_key(5), 0)
    # the population's keyed noise for its members, the dense draw
    # elsewhere
    leaves = tree_leaves(sd.global_params)
    ddraws = ddraws._replace(noise={
        c: client_noise(5, 0, c, leaves) if c in cohort_bad else z
        for c, z in ddraws.noise.items()})
    sd, md = dense.run_round(sd, data, draws=ddraws)
    sp, mp = pop.run_round(sp, pd, draws=pdraws)
    bitwise = _hold_to_dense("random_weights", sd, md, sp, mp,
                             dense.backend.acc, pop.backend.acc, ddraws,
                             pdraws)
    assert {k for k, v in bitwise.items() if not v} <= MAY_DIFFER


def test_client_noise_is_a_function_of_the_client_alone(setup):
    """A malicious member's noise, as the slot-wise attack draws it for
    the whole cohort at once, is the same whichever cohort samples it and
    at whichever slot, and is :func:`client_noise`'s bitwise."""
    _, pop = _pair(setup, participation=0.5, cohort=4,
                   attack="random_weights", num_malicious=6)
    pd = DensePopulationData(setup[1])
    state = pop.init(0)
    leaves = tree_leaves(state.global_params)
    seen, slots = {}, set()
    for seed in range(6):
        # another generator state samples another cohort of this round
        state = state._replace(gen=torch.Generator().manual_seed(seed))
        draws = pop.draw(state, pd)
        assert isinstance(draws.noise, KeyedNoise)
        plan = draws.cohort
        clients = plan.idx.clamp(max=N - 1)
        blocks = [draws.noise.block(i, range(4), clients, 0, leaf.numel())
                  for i, leaf in enumerate(leaves)]
        for s, c in enumerate(plan.ids):
            if c < 2:            # the honest clients of 6 malicious of 8
                continue
            z = [b[s] for b in blocks]
            if c in seen:
                assert all(torch.equal(a, b) for a, b in zip(z, seen[c]))
            else:
                want = client_noise(0, 0, c, leaves)
                assert all(torch.equal(a, b.reshape(-1))
                           for a, b in zip(z, want))
            seen[c] = z
            slots.add((c, s))
    assert len(seen) >= 3 and len(slots) > len(seen)


# ------------------------------------------------------ int8 on the cohort
def test_int8_touches_only_the_cohorts_error_feedback(setup):
    model, data, tc = setup
    fed = FedConfig(num_users=N, num_testers=3, local_steps=2,
                    participation=0.5, cohort=4, compressor="int8",
                    attack="sign_flip", num_malicious=2, fault="dropout",
                    fault_rate=0.4)
    pop = PopulationTrainer(model, fed, tc, eval_batch=32, device="cpu")
    seen = {}
    exchange = pop.backend.compress_exchange

    def keep(compressor, models, global_params, comp_state, part_mask):
        out = exchange(compressor, models, global_params, comp_state,
                       part_mask)
        seen.update(models=models, part_mask=part_mask, out=out)
        return out

    pop.backend.compress_exchange = keep
    pd = DensePopulationData(data)
    state = pop.init(1)
    rng = np.random.default_rng(0)
    state = state._replace(comp_state=_t(rng.standard_normal(
        state.comp_state.shape).astype(np.float32) * 1e-3))
    sentinels = masked = 0
    for _ in range(4):
        before = state.comp_state
        draws = pop.draw(state, pd)
        state, _ = pop.run_round(state, pd, draws=draws)
        models, part = seen["models"], seen["part_mask"]
        decoded, after = seen["out"][2], seen["out"][3]
        assert torch.equal(after, state.comp_state)
        outside = [i for i in range(N) if i not in draws.cohort.ids]
        assert torch.equal(after[outside], before[outside])
        plan = models.plan
        sent = (plan.valid > 0) & (part[plan.idx.clamp(max=N - 1)] > 0)
        assert (decoded[~sent] == 0).all()
        assert (decoded[sent] != 0).any(dim=1).all()
        sentinels += int((plan.valid == 0).sum())
        masked += int(((plan.valid > 0) & ~sent).sum())
        for s, c in enumerate(plan.ids):
            if not sent[s]:
                assert torch.equal(after[c], before[c])
    # the rounds reached a sentinel slot and a dropped member
    assert sentinels > 0 and masked > 0


# ------------------------------------------------------------------ resume
def test_population_run_resumes_bitwise(mlp, tmp_path):
    data = make_federated_image_dataset(MNIST_LIKE, N, num_samples=800,
                                        global_test=100, seed=0,
                                        device="cpu")
    pd = DensePopulationData(data)
    fed = FedConfig(num_users=N, num_testers=3, local_steps=2,
                    participation=0.5, cohort=4, attack="random_weights",
                    num_malicious=2, rounds=5)

    def trainer():
        return PopulationTrainer(mlp, fed, TrainConfig(**TC),
                                 eval_batch=32, device="cpu",
                                 testers_from_cohort=True)

    whole, hist = trainer().run(pd)
    mgr = CheckpointManager(str(tmp_path), save_every=1)
    trainer().run(pd, rounds=2, ckpt=mgr)
    assert mgr.read_manifest()["fed"]["cohort"] == 4
    again = trainer()
    state, at = again.restore_checkpoint(mgr)
    assert at == 2
    resumed, rest = again.run(pd, state=state)
    one = tree_leaves(whole.global_params) + list(whole.scores)
    two = tree_leaves(resumed.global_params) + list(resumed.scores)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert torch.equal(whole.gen.get_state(), resumed.gen.get_state())
    assert rest["global_accuracy"] == hist["global_accuracy"][2:]


# -------------------------------------------- one round on the reference's
def _replay_population(tmp_path=None):
    """One population round of an MLP in both packages (N=8, C=4,
    random_weights, testers from the cohort), the port on the reference's
    draws. With ``tmp_path`` the reference first plays a round and saves
    a checkpoint that the port converts; the round replayed is the next."""
    fed = dict(num_users=N, num_testers=3, num_malicious=2, local_steps=2,
               participation=0.5, cohort=4, attack="random_weights")
    kw = dict(num_samples=800, global_test=100, seed=0)
    jpd = JDensePopulationData(jmake_data(J_MNIST, N, **kw))
    pd = DensePopulationData(make_federated_image_dataset(
        MNIST_LIKE, N, device="cpu", **kw))
    jmodel = jbuild_model(jget_config("fedtest-mlp-mnist").replace(**MLP))
    tmodel = build_model(get_config("fedtest-mlp-mnist").replace(**MLP))
    jtrainer = JPopulationTrainer(jmodel, JFedConfig(**fed),
                                  JTrainConfig(remat=False, **TC),
                                  eval_batch=32, testers_from_cohort=True)
    ttrainer = PopulationTrainer(tmodel, FedConfig(**fed), TrainConfig(**TC),
                                 eval_batch=32, device="cpu",
                                 testers_from_cohort=True)
    jstate = jtrainer.init(jax.random.PRNGKey(3))
    if tmp_path is not None:
        jstate, _ = jtrainer.run_round(jstate, jpd)
        path = jtrainer.save_checkpoint(JCheckpointManager(str(tmp_path)),
                                        jstate)
        tstate = state_from_reference_checkpoint(path, ttrainer)
        assert tstate.round_idx == 1
        for got, want in zip(tree_leaves(tstate.global_params),
                             jax.tree_util.tree_leaves(
                                 jstate.global_params)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        tstate = RoundState(
            global_params=params_from_reference(
                jax.tree_util.tree_map(np.asarray, jstate.global_params),
                "cpu", model=tmodel),
            scores=init_scores(N, "cpu"), round_idx=0,
            gen=torch.Generator())
    rec = _Recorder(jtrainer.backend)
    malicious = jtrainer.attack.malicious_indices(N)

    @jax.jit
    def jround(state):
        keys = round_keys(jax.random.fold_in(state.key, state.round_idx))
        tester_ids, part_mask = jtrainer.program.select_round(
            keys, state.round_idx, scores=state.scores.scores)
        idx, valid, eff = j_cohort_from_mask(part_mask, 4)
        count = jnp.maximum(jnp.sum(valid).astype(jnp.int32), 1)
        tester_ids = jnp.minimum(idx[tester_ids % count], N - 1)
        safe = jnp.minimum(idx, N - 1)
        u = jax.random.uniform(keys.batch, (N, 2, TC["batch_size"]))
        bidx = (u * jpd.train_counts[:, None, None]).astype(jnp.int32)[safe]
        cx, cy = jpd.cohort_train(safe)
        bx = jax.vmap(lambda x, i: x[i])(cx, bidx)
        by = jax.vmap(lambda y, i: y[i])(cy, bidx)
        tx, ty = jpd.tester_batches(tester_ids, 32)
        out = jtrainer.program.run(
            rec, state.global_params, state.scores, bx=(idx, valid, bx),
            by=by, tx=tx, ty=ty, tester_ids=tester_ids, part_mask=eff,
            keys=keys, round_idx=state.round_idx,
            counts=jpd.train_counts, server_data=jpd.server_batch(32),
            comp_state=state.comp_state)
        leaves = jax.tree_util.tree_leaves(state.global_params)
        noise = {c: _client_noise(keys.attack, c, leaves) for c in malicious}
        return out, rec.acc, tester_ids, eff, bidx, idx, valid, noise

    ((jglobal, jscores, _, jmetrics), jacc, tester_ids, eff, bidx, idx,
     valid, noise) = jround(jstate)
    if tmp_path is None:
        # the replayed body is the reference's own round, bitwise
        jnext, _ = jtrainer.run_round(jstate, jpd)
        for a, b in zip(jax.tree_util.tree_leaves(jnext.global_params),
                        jax.tree_util.tree_leaves(jglobal)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ids = tuple(int(i) for i in np.asarray(idx)[np.asarray(valid) > 0])
    # the reference's per-client noise, replayed by slot
    draws = RoundDraws(
        batch_idx=_t(bidx).long(), tester_ids=_t(tester_ids),
        part_mask=_t(eff),
        noise=RecordedNoise({s: [_t(z) for z in noise[c]]
                             for s, c in enumerate(ids) if c in noise}),
        cohort=CohortPlan(_t(idx).long(), _t(valid).float()))
    assert draws.cohort.ids == ids
    ttrainer.backend = _Acc(ttrainer.backend)
    tnew, tmetrics = ttrainer.run_round(tstate, pd, draws=draws)
    np.testing.assert_array_equal(
        (ttrainer.backend.acc * 32).round().numpy(),
        np.round(np.asarray(jacc) * 32))
    assert set(np.asarray(tester_ids).tolist()) <= set(ids)
    pairs = list(zip(tree_leaves(tnew.global_params),
                     jax.tree_util.tree_leaves(jglobal)))
    pairs += [(getattr(tnew.scores, f), getattr(jscores, f))
              for f in tnew.scores._fields]
    pairs += [(tmetrics[k], jmetrics[k]) for k in ("weights",
                                                   "malicious_weight")]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    return tnew


def test_population_round_matches_reference_on_its_draws():
    assert _replay_population().round_idx == 1


def test_reference_population_checkpoint_converts_and_plays_on(tmp_path):
    assert _replay_population(tmp_path).round_idx == 2


# ------------------------------------------------------ SyntheticPopulation
def _small_population(n=1000, **kw):
    return make_synthetic_population(
        n, **{**dict(per_client=5, image_size=8, channels=3, global_test=20,
                     server=10, seed=4, device="cpu"), **kw})


def test_synthetic_population_derives_a_shard_from_its_client():
    pop = _small_population()
    a = pop.cohort_train(torch.tensor([3, 17, 999]))
    b = pop.cohort_train(torch.tensor([17, 2, 3, 3]))
    assert torch.equal(a[0][1], b[0][0]) and torch.equal(a[1][1], b[1][0])
    assert torch.equal(a[0][0], b[0][2]) and torch.equal(b[0][2], b[0][3])
    assert not torch.equal(a[0][0], a[0][1])
    assert a[0].shape == (3, 5, 8, 8, 3) and a[0].dtype == torch.float32
    assert a[1].shape == (3, 5) and a[1].dtype == torch.int32
    assert int(a[1].min()) >= 0 and int(a[1].max()) < 10
    tx, ty = pop.tester_batches(torch.tensor([3, 3], dtype=torch.int32), 7)
    assert tx.shape == (2, 7, 8, 8, 3) and torch.equal(tx[0], tx[1])
    assert not torch.equal(tx[0, :5], a[0][0])     # a disjoint stream
    assert pop.global_x.shape == (20, 8, 8, 3) and pop.global_y.shape == (20,)
    sx, sy = pop.server_batch(4)
    assert sx.shape == (4, 8, 8, 3) and sy.dtype == torch.int32
    assert pop.train_counts.dtype == torch.int32
    assert (pop.train_counts == 5).all() and pop.train_counts.shape == (1000,)
    again = _small_population()
    assert torch.equal(again.cohort_train(torch.tensor([3]))[0][0], a[0][0])
    # the image is its label's prototype plus noise x a standard normal
    z = (a[0] - pop.protos[a[1].long()]) / pop.noise
    assert abs(float(z.mean())) < 0.1 and abs(float(z.std()) - 1) < 0.1


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_a_keyed_shard_is_the_same_in_every_cohort_and_slot(dtype):
    """A client's shard is a function of (seed, stream, client): the same
    in a cohort plan's every slot, padded or not, and in a tester
    gather; a sentinel slot (clamped to N - 1, as the round gathers it)
    draws client N - 1's shard."""
    pop = _small_population(n=50)
    rng = np.random.default_rng(0)
    alone = {c: pop.cohort_train(torch.tensor([c], dtype=dtype))
             for c in (0, 7, 49)}
    for _ in range(3):
        ids = rng.permutation(50)[:8]
        ids[rng.integers(8)] = 7
        idx = torch.tensor(np.append(ids, [50, 50]), dtype=torch.int64)
        xs, ys = pop.cohort_train(idx.clamp(max=49).to(dtype))
        for slot, c in enumerate(idx.clamp(max=49).tolist()):
            if c in alone:
                assert torch.equal(xs[slot], alone[c][0][0])
                assert torch.equal(ys[slot], alone[c][1][0])
    tx, ty = pop.tester_batches(torch.tensor([49, 0], dtype=torch.int32), 5)
    test_alone = pop.tester_batches(torch.tensor([0], dtype=dtype), 5)
    assert torch.equal(tx[1], test_alone[0][0])
    assert torch.equal(ty[1], test_alone[1][0])


def test_a_shards_rows_do_not_depend_on_how_many_are_drawn():
    pop = _small_population(image_size=5, channels=1)   # 25: a padded quad
    ids = torch.tensor([4, 0, 999, 4])
    full = pop.tester_batches(ids, 9)
    for b in (1, 3, 8):
        part = pop.tester_batches(ids, b)
        assert torch.equal(full[0][:, :b], part[0])
        assert torch.equal(full[1][:, :b], part[1])
    again = _small_population(image_size=5, channels=1, per_client=9)
    train = again.cohort_train(ids)
    assert torch.equal(pop.cohort_train(ids)[0], train[0][:, :5])


def test_the_shard_streams_are_disjoint():
    """The train, test and global streams (and the label and image lanes
    within one) draw different values for one client, and a seed changes
    every shard."""
    pop = _small_population(global_test=5, server=5)
    ids = torch.tensor([0, 1])
    train = pop.cohort_train(ids)
    test = pop.tester_batches(ids, 5)
    glob_ = (torch.stack([pop.global_x, pop.server_x]),
             torch.stack([pop.global_y, pop.server_y]))
    for one, two in ((train, test), (train, glob_), (test, glob_)):
        assert not torch.equal(one[0], two[0])
        assert not torch.equal(one[1], two[1])
    other = _small_population(seed=5)
    assert not torch.equal(other.cohort_train(ids)[0], train[0])
    assert torch.equal(other.protos, _small_population(seed=5).protos)


def test_keyed_labels_are_in_range_and_near_uniform():
    pop = _small_population(image_size=2, channels=1, per_client=10)
    ys = pop.cohort_train(torch.arange(1000))[1].reshape(-1).long()
    assert ys.numel() == 10_000
    assert int(ys.min()) == 0 and int(ys.max()) == 9
    counts = torch.bincount(ys, minlength=10)
    # 1,000 a class; 4.5 standard deviations (30 each) either side
    assert int(counts.min()) > 865 and int(counts.max()) < 1135, counts
    chi2 = float(((counts - 1000.0) ** 2 / 1000.0).sum())
    assert chi2 < 27.9              # chi-square, 9 dof, p = 0.001


def test_a_gather_of_100k_ids_reads_nothing_to_the_host():
    pop = make_synthetic_population(100_000, per_client=1, image_size=2,
                                    channels=1, global_test=4, server=4,
                                    seed=0, device="cpu")
    ids = torch.randperm(100_000, generator=torch.Generator().manual_seed(0))
    with NoHostRead():
        xs, ys = pop.cohort_train(ids)
        tx, ty = pop.tester_batches(ids[:8].to(torch.int32), 3)
    assert xs.shape == (100_000, 1, 2, 2, 1) and ys.shape == (100_000, 1)
    assert tx.shape == (8, 3, 2, 2, 1)
    assert torch.equal(xs[:8], pop.cohort_train(ids[:8])[0])


def test_a_gather_past_the_slice_is_drawn_in_blocks(monkeypatch):
    import repro_torch.data.population as population
    pop = _small_population()
    ids = torch.tensor([3, 17, 999, 5])
    whole = pop.cohort_train(ids)
    calls = []
    philox = population.philox4x32

    def spy(counter, key):
        calls.append(counter[2].shape[0])
        return philox(counter, key)
    monkeypatch.setattr(population, "philox4x32", spy)
    # 7 rows of 192 elements a block: 20 rows in blocks of 7, 7, 6
    monkeypatch.setattr(population, "SHARD_SLICE", 7 * 192 + 5)
    got = pop.cohort_train(ids)
    assert calls == [7, 7, 6]
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


def test_a_draw_at_100k_clients_holds_at_most_c_noise_records(mlp):
    n, c = 100_000, 64
    pop = make_synthetic_population(n, per_client=16, seed=0, device="cpu")
    image = 28 * 28
    held = [v for v in vars(pop).values() if isinstance(v, torch.Tensor)]
    assert all(t.numel() < n * image for t in held)
    fed = FedConfig(num_users=n, num_testers=4, num_malicious=20_000,
                    attack="random_weights", local_steps=1, cohort=c,
                    participation=c / n)
    trainer = PopulationTrainer(mlp, fed, TrainConfig(**dict(
        TC, batch_size=2)), eval_batch=8, device="cpu",
        crosstest_block=16, testers_from_cohort=True)
    state = trainer.init(0)
    draws = trainer.draw(state, pop)
    assert len(draws.cohort.ids) <= c and draws.batch_idx.shape == (c, 1, 2)
    # the noise is keyed, not held: the draws hold nothing above [N]
    assert draws.noise == KeyedNoise(noise_key(0), 0)
    assert set(draws.cohort.ids) & set(range(80_000, n))
    held = [t for t in draws if isinstance(t, torch.Tensor)]
    held += list(draws.cohort)
    assert max(t.numel() for t in held) <= n
    state, metrics = trainer.run_round(state, pop, draws=draws)
    w = metrics["weights"]
    outside = torch.ones(n, dtype=torch.bool)
    outside[list(draws.cohort.ids)] = False
    assert (w[outside] == 0).all() and abs(float(w.sum()) - 1) < 1e-5


def test_train_block_trains_the_slots_in_groups(mlp):
    """``train_block`` = k vmaps the local phase over groups of k slots
    (C / k calls of the local step, each on k slots), the grouping of a
    cohort sharded over C / k ranks; the round is the one-group round's
    to rounding."""
    data = make_synthetic_population(16, per_client=20, seed=0,
                                     device="cpu")
    fed = FedConfig(num_users=16, num_testers=2, participation=0.5,
                    cohort=8, local_steps=1, attack="sign_flip",
                    num_malicious=3)
    widths = {}

    def run(block):
        trainer = PopulationTrainer(mlp, fed, TrainConfig(**TC),
                                    eval_batch=8, device="cpu",
                                    train_block=block)
        train = trainer.backend.train

        def spy(local_train, global_params, bx, by):
            def counted(params, x, y):
                widths.setdefault(block, []).append(x.shape)
                return local_train(params, x, y)
            return train(counted, global_params, bx, by)
        trainer.backend.train = spy
        return trainer.run_round(trainer.init(0), data)

    (one, m1), (two, m2) = run(0), run(2)
    assert len(widths[0]) == 1 and len(widths[2]) == 4
    assert torch.equal(m1["weights"], m2["weights"])
    for a, b in zip(tree_leaves(one.global_params),
                    tree_leaves(two.global_params)):
        torch.testing.assert_close(a, b, **OWN)


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("aggregator", ["krum", "trimmed_mean",
                                        "trimmed_mean_coord"])
def test_population_refuses_update_matrix_aggregators(setup, aggregator):
    model, _, tc = setup
    fed = FedConfig(num_users=N, num_testers=3, participation=0.5,
                    cohort=4, aggregator=aggregator, attack="none",
                    num_malicious=2)
    with pytest.raises(ValueError, match="replication wall"):
        PopulationTrainer(model, fed, tc, device="cpu")


def test_population_refuses_eval_resample_and_bad_capacity(setup):
    model, _, tc = setup
    fed = FedConfig(num_users=N, num_testers=3, participation=0.5,
                    cohort=4, attack="none")
    with pytest.raises(ValueError, match="eval_resample"):
        PopulationTrainer(model, fed, tc, device="cpu",
                          eval_resample_every=2)
    # the capacity is FedConfig's cohort, checked there with the
    # reference's messages
    with pytest.raises(ValueError, match=r"cohort=9 must be in \[0"):
        FedConfig(num_users=N, num_testers=3, participation=0.5, cohort=9,
                  attack="none")
    with pytest.raises(ValueError, match="participation < 1.0"):
        FedConfig(num_users=N, num_testers=3, cohort=4, attack="none")
    full = FedConfig(num_users=N, num_testers=3, attack="none")
    # cohort 0 everywhere: the whole population
    assert PopulationTrainer(model, full, tc, device="cpu").capacity == N
    for cap in (0, N + 1):
        with pytest.raises(ValueError, match="capacity"):
            PopulationBackend(N, cap)
    with pytest.raises(NotImplementedError, match="replication wall"):
        PopulationBackend(N, 4).updates(None, None)


@pytest.mark.parametrize("argv,match", [
    (["--cohort", "4"], "--cohort requires --population"),
    (["--population", "12", "--users", "12"], "replaces --users"),
    (["--population", "12", "--eval-resample-every", "2"],
     "dense-driver feature"),
    (["--population", "4", "--cohort", "8", "--testers", "2"],
     "cohort=8 must be in"),
    (["--population", "4", "--cohort", "8", "--scenario", "honest"],
     "cohort=8 must be in"),
])
def test_cli_refusals(argv, match):
    with pytest.raises((SystemExit, ValueError), match=match):
        train_mod.fed_config(train_mod.parse_args(argv))


def test_cli_population_fed_config_is_the_references():
    args = train_mod.parse_args(["--population", "4096", "--cohort", "32",
                                 "--scenario", "full_collusion_vs_fedtest",
                                 "--testers", "8"])
    fed = train_mod.fed_config(args)
    want = dataclasses.replace(jscenarios.scenario_for_population(
        "full_collusion_vs_fedtest", 4096, 32), num_testers=8)
    assert dataclasses.asdict(fed) == dataclasses.asdict(want)
    fed = train_mod.fed_config(train_mod.parse_args(["--population", "12"]))
    assert fed.cohort == 12 and fed.participation == 1.0
    fed = train_mod.fed_config(train_mod.parse_args(
        ["--population", "12", "--cohort", "4"]))
    assert fed.num_users == 12 and fed.participation == 4 / 12


def test_cli_runs_the_population_tier_on_the_cpu(tmp_path):
    train_mod.main([
        "--device", "cpu", "--dataset", "mnist_like", "--arch",
        "fedtest-mlp-mnist", "--population", "12", "--cohort", "4",
        "--testers", "3", "--testers-from-cohort", "--malicious", "2",
        "--samples", "1200", "--local-steps", "2", "--batch", "16",
        "--rounds", "3", "--out", str(tmp_path)])
    (out,) = os.listdir(tmp_path)
    with open(os.path.join(tmp_path, out)) as f:
        hist = json.load(f)
    assert hist["round"] == [1, 2, 3]
    assert hist["config"]["cohort"] == 4
    assert hist["config"]["testers_from_cohort"] is True
    assert all(np.isfinite(hist[k]).all() for k in (
        "global_accuracy", "local_loss", "malicious_weight"))


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_runs_the_reference_ci_population_job():
    """``chip_smoke.ci_population`` builds the reference CI's
    ``population-smoke`` job as ``repro.launch.federated --population``
    builds it: its FedConfig field for field, the CNN cut to (8, 16, 16)
    channels and a hidden width of 32, sgd at lr 0.1, 64 MNIST-like rows
    a client and eval batches of 64, the testers from the cohort."""
    from repro.launch import federated as jfederated
    cs = _chip_smoke()
    trainer, data = cs.ci_population("cpu")
    base = dict(jfederated._FED_CLI_DEFAULTS,
                num_testers=min(8, cs.CI_COHORT))
    base.update(num_testers=cs.CI_TESTERS, num_malicious=cs.CI_MALICIOUS,
                local_steps=cs.CI_STEPS, attack="sign_flip",
                rounds=cs.CI_ROUNDS, seed=0, num_users=cs.CI_POPULATION,
                cohort=cs.CI_COHORT,
                participation=cs.CI_COHORT / cs.CI_POPULATION)
    assert dataclasses.asdict(trainer.fed) == dataclasses.asdict(
        JFedConfig(**base))
    want = jget_config("fedtest-cnn-mnist").replace(
        cnn_channels=(8, 16, 16), cnn_hidden=32)
    got = trainer.model.cfg
    for field in ("family", "image_size", "image_channels", "cnn_channels",
                  "cnn_hidden", "num_classes"):
        assert getattr(got, field) == getattr(want, field), field
    tc = trainer.train
    assert (tc.optimizer, tc.lr, tc.schedule, tc.batch_size,
            tc.grad_clip) == ("sgd", 0.1, "constant", cs.CI_BATCH, 0.0)
    assert trainer.eval_batch == 64 and trainer.testers_from_cohort
    assert data.per_client == 64 and data.num_clients == cs.CI_POPULATION
    assert tuple(data.protos.shape) == (J_MNIST.num_classes,
                                        J_MNIST.image_size,
                                        J_MNIST.image_size,
                                        J_MNIST.channels)
    assert data.noise == J_MNIST.noise
