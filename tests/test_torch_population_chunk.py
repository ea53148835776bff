"""The population tier's chunk of rounds (``PopulationTrainer`` at
``rounds_per_call`` > 1) and the round with no host read, on the CPU.

On the card a chunk is R replays of one CUDA graph of the tier's round
(``chip_smoke.py``'s phase R, path G, holds it to eager rounds bitwise);
here it is the same round body on the same static buffers in a loop. At
a small MLP (N = 12, C = 4):

* a chunk of 4 equals 4 eager rounds bitwise (params, scores, trust, the
  generator, the error feedback) for ``sign_flip``, ``random_weights``
  (the keyed noise), int8 with dropout and testers from the cohort, and
  over a ``SyntheticPopulation`` (its keyed shards drawn in the round)
  with the identity exchange and with int8;
* the rounds at which a chunked ``run`` reads the global accuracy are the
  reference ``PopulationTrainer``'s for the same ``rounds_per_call`` and
  ``eval_every`` (the values are the packages' own draws, not compared);
* a resume through the chunked driver is bitwise the unbroken run;
* the round runs under a dispatch mode that refuses every op that reads a
  tensor to the host (``aten._local_scalar_dense``, ``nonzero``,
  ``masked_select``, ``unique``, a boolean-mask index): the CPU stand-in
  for a CUDA graph capture's refusal, over both providers;
* the keyed noise is a function of the client alone and is drawn in
  blocks: no ``[C, D]`` tensor at a leaf of more than ``NOISE_SLICE``;
* a chunk refuses a provider other than the one it ran on (a second
  ``SyntheticPopulation`` of the same seed), and a ``group``;
* the train CLI's ``--assert-malicious-below`` under and over its bar,
  and ``--population`` with ``--rounds-per-call``.

Torch runs on one thread here: these small ops lose more to thread
hand-offs than they gain when the suite's other workers share the cores.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.engine.population import (  # noqa: E402
    PopulationTrainer as JPopulationTrainer)
from repro.data import MNIST_LIKE as J_MNIST  # noqa: E402
from repro.data import make_federated_image_dataset as jmake_data  # noqa: E402
from repro.data.population import (  # noqa: E402
    DensePopulationData as JDensePopulationData)
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.engine import PopulationTrainer  # noqa: E402
from repro_torch.core.engine.population import (  # noqa: E402
    KeyedNoise, client_noise, noise_key)
from repro_torch.data import (  # noqa: E402
    MNIST_LIKE, DensePopulationData, make_federated_image_dataset,
    make_synthetic_population)
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.strategies import ATTACKS  # noqa: E402
from repro_torch.strategies.base import AttackContext  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

N, C, R = 12, 4, 4
MLP = dict(mlp_hidden=(16,))
TC = dict(optimizer="sgd", lr=0.1, schedule="constant", batch_size=8,
          grad_clip=0.0)
BASE = dict(num_users=N, num_testers=3, local_steps=2, participation=C / N,
            cohort=C)
CASES = {
    "sign_flip": dict(attack="sign_flip", num_malicious=3),
    "random_weights": dict(attack="random_weights", num_malicious=3),
    "int8_dropout": dict(attack="random_weights", num_malicious=3,
                         compressor="int8", fault="dropout", fault_rate=0.3,
                         aggregator_kwargs={"use_trust": True}),
    "testers_from_cohort": dict(attack="sign_flip", num_malicious=3),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mlp():
    model = build_model(get_config("fedtest-mlp-mnist").replace(**MLP))
    data = DensePopulationData(make_federated_image_dataset(
        MNIST_LIKE, N, num_samples=1200, global_test=64, seed=0,
        device="cpu"))
    return model, data


def _synthetic(seed=0):
    """A keyed population of the MLP's MNIST-like shape: N clients of 100
    rows, as the dense fixture's."""
    return make_synthetic_population(N, per_client=100, global_test=64,
                                     seed=seed, device="cpu")


PROVIDERS = {"dense": lambda mlp: mlp[1], "synthetic": lambda mlp:
             _synthetic()}


def _trainer(mlp, case="sign_flip", rounds_per_call=1, **fed):
    return PopulationTrainer(
        mlp[0], FedConfig(**{**BASE, **CASES[case], **fed}), TrainConfig(**TC),
        eval_batch=16, device="cpu", rounds_per_call=rounds_per_call,
        testers_from_cohort=case in ("testers_from_cohort", "int8_dropout"))


def _tensors(state):
    out = tree_leaves(state.global_params) + list(state.scores)
    return out + ([] if state.comp_state is None else [state.comp_state])


def _assert_bitwise(want, got):
    assert want.round_idx == got.round_idx
    one, two = _tensors(want), _tensors(got)
    assert len(one) == len(two)
    for a, b in zip(one, two):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert torch.equal(want.gen.get_state(), got.gen.get_state())


# ------------------------------------------------ (d) a chunk == R rounds
@pytest.mark.parametrize("case", sorted(CASES))
def test_population_chunk_is_bitwise_eager_rounds(mlp, case):
    data = mlp[1]
    eager = _trainer(mlp, case)
    state, singles = eager.init(3), []
    for _ in range(R):
        state, metrics = eager.run_round(state, data)
        singles.append(metrics)
    chunked = _trainer(mlp, case, rounds_per_call=R)
    got, stacked = chunked.run_chunk(chunked.init(3), data)
    _assert_bitwise(state, got)
    assert chunked.chunk is not None and chunked.chunk.key is not None
    for k, v in stacked.items():
        assert v.shape[0] == R
        for r in range(R):
            assert torch.equal(v[r], singles[r][k]), (k, r)


@pytest.mark.parametrize("case", ["random_weights", "int8_dropout"])
def test_a_chunk_over_a_synthetic_population_is_its_eager_rounds(mlp,
                                                                  case):
    """The keyed shards are drawn inside the chunk's round: R rounds of
    a chunk over a ``SyntheticPopulation`` are R eager rounds, bitwise,
    with the identity exchange and with int8."""
    data = _synthetic()
    eager = _trainer(mlp, case)
    state, singles = eager.init(5), []
    for _ in range(R):
        state, metrics = eager.run_round(state, data)
        singles.append(metrics)
    chunked = _trainer(mlp, case, rounds_per_call=R)
    got, stacked = chunked.run_chunk(chunked.init(5), data)
    _assert_bitwise(state, got)
    assert chunked.chunk.data is data
    for k, v in stacked.items():
        for r in range(R):
            assert torch.equal(v[r], singles[r][k]), (k, r)


# -------------------------------------- (e) history rounds, the reference
@pytest.mark.parametrize("rounds,rounds_per_call,eval_every", [
    (7, 3, 2), (6, 4, 4)])
def test_population_history_rounds_are_the_references(
        mlp, rounds, rounds_per_call, eval_every):
    fed = dict(num_users=8, num_testers=2, local_steps=1, attack="none",
               participation=0.5, cohort=4)
    jmodel = jbuild_model(jget_config("fedtest-mlp-mnist").replace(**MLP))
    jdata = JDensePopulationData(jmake_data(J_MNIST, 8, num_samples=400,
                                            global_test=64, seed=0))
    jtrainer = JPopulationTrainer(jmodel, JFedConfig(**fed),
                                  JTrainConfig(remat=False, **TC),
                                  eval_batch=16,
                                  rounds_per_call=rounds_per_call)
    _, jhist = jtrainer.run(jax.random.PRNGKey(0), jdata, rounds=rounds,
                            eval_every=eval_every)
    data = DensePopulationData(make_federated_image_dataset(
        MNIST_LIKE, 8, num_samples=400, global_test=64, seed=0,
        device="cpu"))
    trainer = PopulationTrainer(mlp[0], FedConfig(**fed), TrainConfig(**TC),
                                eval_batch=16, device="cpu",
                                rounds_per_call=rounds_per_call)
    _, hist = trainer.run(data, rounds=rounds, eval_every=eval_every)
    assert hist["round"] == jhist["round"]


# ------------------------------------------------------------- (f) resume
def test_population_resume_through_chunks_is_bitwise(mlp, tmp_path):
    data = mlp[1]
    whole, hist = _trainer(mlp, "random_weights").run(data, rounds=9)
    mgr = CheckpointManager(str(tmp_path), save_every=3)
    _trainer(mlp, "random_weights", rounds_per_call=3).run(data, rounds=3,
                                                           ckpt=mgr)
    again = _trainer(mlp, "random_weights", rounds_per_call=3)
    state, at = again.restore_checkpoint(mgr)
    assert at == 3
    resumed, rest = again.run(data, rounds=9, state=state)
    _assert_bitwise(whole, resumed)
    assert rest["round"] == [6, 9]
    assert rest["global_accuracy"] == [hist["global_accuracy"][5],
                                       hist["global_accuracy"][8]]


# -------------------------------------------------- (g) no read to the host
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
              "_unique", "_unique2", "unique_dim", "unique_consecutive"}
MASK_INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}


class NoHostRead(TorchDispatchMode):
    """Raises on every op that reads a tensor to the host, and on an
    index by a boolean mask (its size is the mask's count)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_READS:
            raise RuntimeError(f"host read: {func}")
        if name in MASK_INDEXING and any(
                isinstance(i, torch.Tensor)
                and i.dtype in (torch.bool, torch.uint8) for i in args[1]):
            raise RuntimeError(f"boolean-mask index: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("provider", sorted(PROVIDERS))
def test_the_population_round_reads_nothing_to_the_host(mlp, provider):
    data = PROVIDERS[provider](mlp)
    # every seam the round has: keyed noise, int8 error feedback, dropout,
    # trust, testers from the cohort, and a coalition's device routing
    trainer = _trainer(mlp, "int8_dropout", coalition="sybil_split",
                       coalition_size=2)
    state = trainer.init(1)
    state, _ = trainer.run_round(state, data)     # the lazy set-up
    with NoHostRead():
        state, metrics = trainer.run_round(state, data)
        state, metrics = trainer.run_round(state, data)
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
    # the mode sees a host read
    with pytest.raises(RuntimeError, match="host read"):
        with NoHostRead():
            int(state.scores.scores.sum())
    with pytest.raises(RuntimeError, match="boolean-mask"):
        with NoHostRead():
            state.scores.scores[state.scores.scores > 0]


# ------------------------------------------------------- (h) keyed noise
def test_keyed_noise_is_the_clients_and_drawn_in_blocks(monkeypatch):
    """``client_noise`` is a function of (seed, round, client) alone; the
    slot-wise attack draws no block above ``NOISE_SLICE`` elements (cut
    here to 4,096 so a leaf of 6,144 is a large one: two slices a slot)
    and packs whole rows of a small leaf into one block, each slot equal
    to the dense attack on its client's draw bitwise."""
    leaves = [torch.zeros(5, 7), torch.zeros(3)]
    a = client_noise(0, 2, 9, leaves)
    assert [t.shape for t in a] == [(5, 7), (3,)]
    assert all(torch.equal(x, y) for x, y in zip(a, client_noise(
        0, 2, 9, leaves)))
    for other in ((1, 2, 9), (0, 3, 9), (0, 2, 8)):
        assert not torch.equal(client_noise(*other, leaves)[0], a[0])
    z = client_noise(0, 0, 0, [torch.zeros(1 << 16)])[0]
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02

    import repro_torch.core.attacks as attacks
    import repro_torch.core.engine.population as population
    monkeypatch.setattr(attacks, "NOISE_SLICE", 4096)
    blocks = []
    keyed = population.keyed_normal

    def spy(key, words, lo, hi, device=None):
        out = keyed(key, words, lo, hi, device)
        blocks.append(tuple(out.shape))
        return out
    monkeypatch.setattr(population, "keyed_normal", spy)
    rng = np.random.default_rng(0)
    stack = {"big": torch.from_numpy(rng.standard_normal(
        (3, 6144)).astype(np.float32)),
        "small": torch.from_numpy(rng.standard_normal(
            (3, 10, 100)).astype(np.float32))}
    glob = {k: torch.zeros(v.shape[1:]) for k, v in stack.items()}
    atk = ATTACKS.build("random_weights", {}, dict(num_malicious=2))
    w = torch.full((4,), 0.25)
    ctx = AttackContext(scores=w, weights=w, round_idx=5)
    clients = torch.tensor([2, 0, 3])
    out = atk.apply_slots(KeyedNoise(noise_key(7), 5), stack, glob, ctx,
                          clients, torch.tensor([True, False, True]),
                          range(3))
    # "big": 3 slots x 2 slices of [1, 4096] and [1, 2048]; "small": its
    # 3 rows of 1,000 in one [3, 1000] block
    assert sorted(blocks) == sorted([(1, 4096), (1, 2048)] * 3 + [(3, 1000)])
    assert all(r * c <= 4096 for r, c in blocks)
    for k in stack:
        assert torch.equal(out[k][1], stack[k][1])
    for s, c in ((0, 2), (2, 3)):
        want = atk.corrupt(client_noise(7, 5, c, tree_leaves(glob)),
                           {k: v[s] for k, v in stack.items()}, glob, ctx,
                           c)
        for k in stack:
            assert torch.equal(out[k][s], want[k]), (k, s)


# --------------------------------------------------------- (i) refusals
def test_a_chunk_refuses_synthetic_populations_and_groups(mlp):
    """A chunk reads the provider it ran on first (on the card its
    capture holds the population's Philox key): another
    ``SyntheticPopulation``, even one of the same seed, is refused, and
    so is a ``group``."""
    pop = _synthetic()
    chunked = _trainer(mlp, rounds_per_call=2)
    state, _ = chunked.run_chunk(chunked.init(0), pop)
    with pytest.raises(ValueError, match="dataset it was captured on"):
        chunked.run_chunk(state, _synthetic())
    with pytest.raises(ValueError, match="dataset it was captured on"):
        chunked.run_chunk(state, mlp[1])
    assert chunked.chunk.data is pop
    state, _ = chunked.run_chunk(state, pop)
    assert state.round_idx == 4

    class Group:
        world_size, rank, device = 1, 0, "cpu"
    with pytest.raises(ValueError, match="sharded population tier"):
        PopulationTrainer(mlp[0], FedConfig(**BASE), TrainConfig(**TC),
                          device="cpu", rounds_per_call=2, group=Group())


# ------------------------------------------------------------ (j) the CLI
ARGV = ["--device", "cpu", "--arch", "fedtest-mlp-mnist", "--dataset",
        "mnist_like", "--population", "12", "--cohort", "4", "--testers",
        "3", "--testers-from-cohort", "--malicious", "3", "--attack",
        "random_weights", "--samples", "1200", "--local-steps", "2",
        "--batch", "8", "--rounds", "5", "--rounds-per-call", "2"]


@pytest.mark.parametrize("bar,passes", [(1.0, True), (0.0, False)])
def test_cli_asserts_the_malicious_weight_below_a_bar(tmp_path, capsys, bar,
                                                      passes):
    argv = ARGV + ["--out", str(tmp_path), "--assert-malicious-below",
                   str(bar)]
    if passes:
        train_mod.main(argv)
        assert "assert ok: malicious_weight=" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit, match="did not drop below 0.0 "
                                             "after 5 rounds"):
            train_mod.main(argv)
    hist = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert hist["round"] == [2, 4, 5]
    assert hist["config"]["rounds_per_call"] == 2
    assert all(np.isfinite(hist["malicious_weight"]))
