"""The port's pod round against the reference, and its sharded population
tier against its unsharded one, on the CPU: four gloo ranks, both parts
in one spawned group (``_torch_pod_ranks.replay_rank``).

* the ring round (``make_distributed_round``, sign_flip, participation
  0.75) from the reference's init on the reference's draws, replayed
  through ``RoundDraws``, against the reference's local round (which
  ``tests/test_pod_parity.py`` pins bitwise to its own pod round): the
  ``[K, N]`` counts exactly, the weights and malicious weight at 1e-6,
  the params within rtol 1e-4 / atol 1e-5;
* the population tier with its cohort of C = 8 sharded over W = 4 ranks
  (N = 64, sign_flip, testers from the cohort, 3 rounds) against the
  unsharded ``PopulationTrainer`` on the same draws: the counts, every
  discrete field, the scores, the weights and the malicious weight
  bitwise, the params within rtol 1e-5 / atol 1e-6; and bitwise, the
  params too, against the unsharded run that trains its slots in the
  ranks' groups (``train_block`` = C / W).

Torch runs one thread a process.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_pod_ranks as ranks  # noqa: E402
from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.core.engine import LocalBackend as JLocalBackend  # noqa: E402
from repro.core.engine import round_keys  # noqa: E402
from repro.data import MNIST_LIKE as J_MNIST  # noqa: E402
from repro.data import make_federated_image_dataset as jmake_data  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

ROUNDS = 2
FED = dict(num_users=ranks.N, num_testers=ranks.N, num_malicious=1,
           attack="sign_flip", attack_scale=4.0, participation=0.75,
           local_steps=2, seed=0)
RTOL, ATOL = 1e-4, 1e-5
OWN = dict(rtol=1e-5, atol=1e-6)
EXACT = ("weights", "scores", "malicious_weight", "participation_rate",
         "dropped_fraction", "acc_matrix_mean")


class _Recorder:
    """The reference's backend, keeping each round's [K, N] matrix."""

    def __init__(self, backend):
        self.backend = backend
        self.acc = None

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def cross_test(self, *args):
        acc, cache = self.backend.cross_test(*args)
        self.acc = acc
        return acc, cache


def _reference_rounds():
    """The reference's local rounds with the draws each consumed: its
    init (numpy), per round the draws and the [K, N] matrix, and its
    final state."""
    n, steps, batch = ranks.N, FED["local_steps"], ranks.TRAIN["batch_size"]
    jdata = jmake_data(J_MNIST, n, **ranks.MATRIX_DATA)
    jmodel = jbuild_model(jget_config("fedtest-cnn-mnist").replace(
        **ranks.CNN))
    tc = dict(ranks.TRAIN)
    jtrainer = JTrainer(jmodel, JFedConfig(**FED),
                        JTrainConfig(remat=False, **tc),
                        eval_batch=ranks.EVAL)
    state = jtrainer.init(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, state.global_params)
    rows = jnp.arange(n)[:, None, None]

    @jax.jit
    def jround(state):
        keys = round_keys(jax.random.fold_in(state.key, state.round_idx))
        tester_ids, part_mask = jtrainer.program.select_round(
            keys, state.round_idx, scores=state.scores.scores)
        u = jax.random.uniform(keys.batch, (n, steps, batch))
        batch_idx = (u * jdata.train.counts[:, None, None]
                     ).astype(jnp.int32)
        rec = _Recorder(JLocalBackend(n))
        new_global, new_scores, _, metrics = jtrainer.program.run(
            rec, state.global_params, state.scores,
            bx=jdata.train.xs[rows, batch_idx],
            by=jdata.train.ys[rows, batch_idx],
            tx=jdata.test.xs[:, :ranks.EVAL],
            ty=jdata.test.ys[:, :ranks.EVAL], tester_ids=tester_ids,
            part_mask=part_mask, keys=keys, round_idx=state.round_idx,
            counts=jdata.train.counts,
            server_data=(jdata.server_x[:ranks.EVAL],
                         jdata.server_y[:ranks.EVAL]))
        state = state._replace(global_params=new_global, scores=new_scores,
                               round_idx=state.round_idx + 1)
        return state, metrics, rec.acc, batch_idx, tester_ids, part_mask

    draws, accs, metrics = [], [], []
    for _ in range(ROUNDS):
        before = state
        state, m, acc, batch_idx, tester_ids, part_mask = jround(state)
        # the replayed body is the reference's own round, bitwise
        want, _ = jtrainer.run_round(before, jdata)
        for a, b in zip(jax.tree_util.tree_leaves(want.global_params),
                        jax.tree_util.tree_leaves(state.global_params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        draws.append(dict(batch_idx=np.asarray(batch_idx).astype(np.int64),
                          tester_ids=np.asarray(tester_ids),
                          part_mask=np.asarray(part_mask)))
        accs.append(np.asarray(acc))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    final = [np.asarray(p)
             for p in jax.tree_util.tree_leaves(state.global_params)]
    return init, draws, accs, metrics, final


@pytest.fixture(scope="module")
def replayed():
    """(reference, pod ranks' results, the unsharded population run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        init, draws, accs, metrics, final = _reference_rounds()
        model, _ = ranks.model_and_train()
        tinit = params_from_reference(init, "cpu", model=model)
        tinit = jax.tree_util.tree_map(lambda t: t.numpy(), tinit)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            pod = pool.submit(run_ranks, ranks.replay_rank, ranks.N, FED,
                              tinit, draws, threads=1, timeout_s=120,
                              join_timeout_s=300)
            trainer, data = ranks.population_trainer()
            rounds = ranks.population_fed()["rounds"]
            unsharded, _ = ranks.play(trainer, data, rounds)
            grouped = dataclasses.replace(
                trainer, train_block=trainer.capacity // ranks.N)
            unsharded["grouped"], _ = ranks.play(grouped, data, rounds)
            pod = pod.result()
    finally:
        torch.set_num_threads(threads)
    return dict(accs=accs, metrics=metrics, final=final), pod, unsharded


def _counts(acc, rows):
    return np.rint(np.asarray(acc) * rows).astype(np.int64)


@pytest.mark.parametrize("round_idx", range(ROUNDS))
def test_pod_counts_match_the_reference(replayed, round_idx):
    ref, pod, _ = replayed
    want = _counts(ref["accs"][round_idx], ranks.EVAL)
    for rank in range(ranks.N):
        np.testing.assert_array_equal(
            _counts(pod[rank]["acc"][round_idx], ranks.EVAL), want,
            err_msg=f"rank {rank}")


@pytest.mark.parametrize("round_idx", range(ROUNDS))
def test_pod_weights_match_the_reference(replayed, round_idx):
    ref, pod, _ = replayed
    got, want = pod[0]["metrics"][round_idx], ref["metrics"][round_idx]
    for k in ("weights", "malicious_weight", "participation_rate"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_pod_params_match_the_reference(replayed):
    ref, pod, _ = replayed
    for rank in range(ranks.N):
        for got, want in zip(pod[rank]["params"], ref["final"]):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the sign_flip attacker was engaged and sampled at least once
    assert any(m["malicious_weight"] > 0 for m in ref["metrics"])


@pytest.mark.parametrize("round_idx", range(3))
def test_sharded_population_round_matches_unsharded(replayed, round_idx):
    _, pod, unsharded = replayed
    want = unsharded["metrics"][round_idx]
    for rank in range(ranks.N):
        got = pod[rank]["population"]
        np.testing.assert_array_equal(
            _counts(got["acc"][round_idx], 32),
            _counts(unsharded["acc"][round_idx], 32))
        for k in EXACT:
            np.testing.assert_array_equal(got["metrics"][round_idx][k],
                                          want[k], err_msg=f"{rank}: {k}")
        np.testing.assert_allclose(got["metrics"][round_idx]["local_loss"],
                                   want["local_loss"], **OWN)


def test_sharded_population_state_matches_unsharded(replayed):
    _, pod, unsharded = replayed
    for rank in range(ranks.N):
        got = pod[rank]["population"]
        for a, b in zip(got["scores"], unsharded["scores"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["gen"], unsharded["gen"])
        for a, b in zip(got["params"], unsharded["params"]):
            np.testing.assert_allclose(a, b, **OWN)
    assert any(m["malicious_weight"] > 0 for m in unsharded["metrics"])


def test_sharded_population_is_the_unsharded_in_the_ranks_groups(replayed):
    """Trained in the ranks' groups of C / W slots, the unsharded tier is
    the sharded one bitwise: params, scores, generator, the accuracy
    matrices and every round's metrics."""
    _, pod, unsharded = replayed
    for rank in range(ranks.N):
        ranks.same_run(pod[rank]["population"], unsharded["grouped"],
                       f"rank {rank}")
