"""The port's multi-round driver (``rounds_per_call``, ``run_chunk``) on
the CPU, against its own single-round driver and against the reference's
scanned driver.

On the card a chunk is R replays of one CUDA graph of a round
(``chip_smoke.py``'s phase R holds it to eager rounds bitwise); on the
CPU it is the same round body on the same static buffers and device
counter, in a loop. Here, at the reference tests' tiny CNN (and an MLP):

* R = 4 over 8 rounds, and a remainder (5 rounds at R = 3), bitwise the
  single rounds: every param, scores, trust, ``rounds_seen``, the
  generator state and the error feedback; NaN bit patterns included
  (sign_flip at scale 4 drives the tiny CNN to NaN, as in the
  reference's test);
* ``history["round"]`` is the reference ``FederatedTrainer.run``'s for
  the same ``(rounds, rounds_per_call, eval_every)``;
* a resume through the chunked driver from a checkpoint at round 6 is
  bitwise the unbroken single-round run;
* eval resampling every 2 rounds with R = 2 at participation 0.75;
* ``round_robin``, ``coverage`` and the ``targeted`` fault across chunk
  boundaries: tester ids and participation masks those of single rounds;
* the device counter ends at the host's round; one capture a trainer,
  so a chunk on another dataset is refused; eval rows follow each
  chunk's seed; the train CLI takes the flag (the population tier's
  chunks are held in ``tests/test_torch_population_chunk.py``);
* one LM round chunk (reduced ``qwen2-0.5b``) bitwise two single rounds.

Torch runs on one thread here, as in ``tests/test_torch_lm_round.py``:
these small ops lose more to thread hand-offs than they gain when the
suite's other workers share the cores.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.data import MNIST_LIKE as J_MNIST  # noqa: E402
from repro.data import make_federated_image_dataset as jmake_data  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.data import (  # noqa: E402
    MNIST_LIKE, make_federated_image_dataset)
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.strategies import FAULTS, SELECTORS  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

CNN = dict(cnn_channels=(4, 8, 8), cnn_hidden=16)
MLP = dict(mlp_hidden=(16,))
TC = dict(optimizer="sgd", lr=0.1, schedule="constant", batch_size=8,
          grad_clip=0.0)
SAMPLES = dict(num_samples=800, global_test=200, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cnn():
    model = build_model(get_config("fedtest-cnn-mnist").replace(**CNN))
    data = make_federated_image_dataset(MNIST_LIKE, 4, device="cpu",
                                        **SAMPLES)
    return model, data, TrainConfig(**TC)


@pytest.fixture(scope="module")
def mlp():
    model = build_model(get_config("fedtest-mlp-mnist").replace(**MLP))
    data = make_federated_image_dataset(MNIST_LIKE, 6, device="cpu",
                                        **SAMPLES)
    return model, data, TrainConfig(**TC)


def _trainer(setup, rounds_per_call=1, eval_resample_every=0, **fed):
    model, data, tc = setup
    base = dict(num_users=data.train.counts.shape[0], num_testers=2,
                local_steps=2)
    return FederatedTrainer(model, FedConfig(**{**base, **fed}), tc,
                            eval_batch=64, device="cpu",
                            rounds_per_call=rounds_per_call,
                            eval_resample_every=eval_resample_every)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit pattern, so NaNs compare by their bits."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def _tensors(state):
    out = {f"param {i}": t
           for i, t in enumerate(tree_leaves(state.global_params))}
    out.update({f"scores.{k}": v for k, v in state.scores._asdict().items()})
    out["gen_state"] = state.gen.get_state()
    if state.comp_state is not None:
        out["comp_state"] = state.comp_state
    return out


def _assert_bitwise(one, two):
    a, b = _tensors(one), _tensors(two)
    assert a.keys() == b.keys()
    differ = [k for k in a if not torch.equal(_bits(a[k]), _bits(b[k]))]
    assert not differ, differ
    assert (one.round_idx, one.seed) == (two.round_idx, two.seed)


def _singles(trainer, data, rounds, state=None):
    state = trainer.init() if state is None else state
    metrics = []
    for _ in range(rounds - state.round_idx):
        state, m = trainer.run_round(state, data)
        metrics.append(m)
    return state, metrics


# ------------------------------------------------- chunks against singles
def test_chunked_driver_matches_single_rounds_bitwise(cnn):
    """R = 4 over 8 rounds == 8 single rounds; one capture; the history
    reads the global accuracy at the chunk boundaries."""
    data = cnn[1]
    fed = dict(num_malicious=1, attack="sign_flip", attack_scale=4.0)
    single = _trainer(cnn, **fed)
    chunked = _trainer(cnn, rounds_per_call=4, **fed)
    s_state, s_hist = single.run(data, rounds=8)
    c_state, c_hist = chunked.run(data, rounds=8)
    _assert_bitwise(s_state, c_state)
    assert c_state.round_idx == 8
    assert chunked.chunk is not None and chunked.chunk.graph is None
    assert int(chunked.chunk.counter) == c_state.round_idx
    assert c_hist["round"] == [4, 8]
    for key in ("global_accuracy", "local_loss", "malicious_weight"):
        for r, v in zip(c_hist["round"], c_hist[key]):
            want = s_hist[key][s_hist["round"].index(r)]
            assert np.array_equal(v, want, equal_nan=True), key


def test_chunk_metrics_stack_every_round(cnn):
    """A chunk's metrics are the single rounds' stacked [R], bitwise."""
    data = cnn[1]
    fed = dict(num_malicious=1, attack="random_weights")
    _, singles = _singles(_trainer(cnn, **fed), data, 3)
    chunked = _trainer(cnn, rounds_per_call=3, **fed)
    _, stacked = chunked.run_chunk(chunked.init(), data)
    assert stacked.keys() == singles[0].keys()
    for key, v in stacked.items():
        assert v.shape[0] == 3
        for r, m in enumerate(singles):
            assert torch.equal(_bits(v[r]), _bits(m[key])), (key, r)


def test_chunked_driver_remainder_rounds(cnn):
    """5 rounds at R = 3: one chunk, then 2 single rounds; bitwise the
    single-round run, and the one capture."""
    data = cnn[1]
    fed = dict(attack="none")
    trainer = _trainer(cnn, rounds_per_call=3, **fed)
    state, hist = trainer.run(data, rounds=5)
    assert state.round_idx == 5
    assert trainer.chunk is not None
    assert hist["round"] == [3, 4, 5]
    _assert_bitwise(_singles(_trainer(cnn, **fed), data, 5)[0], state)


def test_chunks_carry_compression_and_trust_bitwise(cnn):
    """int8's error feedback and FedTest's tester trust thread through the
    static buffers as the single rounds carry them."""
    data = cnn[1]
    fed = dict(num_malicious=1, attack="random_weights", compressor="int8",
               aggregator_kwargs={"use_trust": True, "trust_decay": 0.3})
    chunked = _trainer(cnn, rounds_per_call=2, **fed)
    state, _ = chunked.run(data, rounds=5)
    assert state.comp_state is not None
    _assert_bitwise(_singles(_trainer(cnn, **fed), data, 5)[0], state)


# ------------------------------------------------- history vs the reference
@pytest.fixture(scope="module")
def jtiny():
    cfg = jget_config("fedtest-mlp-mnist").replace(**MLP)
    data = jmake_data(J_MNIST, 4, num_samples=400, global_test=64, seed=0)
    return jbuild_model(cfg), data


@pytest.mark.parametrize("rounds,rounds_per_call,eval_every", [
    (8, 4, 1), (5, 3, 1), (7, 2, 3), (6, 3, 4), (9, 4, 2)])
def test_history_rounds_are_the_references(mlp, jtiny, rounds,
                                           rounds_per_call, eval_every):
    """The rounds at which ``run`` reads the global accuracy: every
    ``eval_every`` rounds, the last, and every chunk boundary."""
    jmodel, jdata = jtiny
    fed = dict(num_users=4, num_testers=2, local_steps=1, attack="none")
    jtrainer = JTrainer(jmodel, JFedConfig(**fed),
                        JTrainConfig(remat=False, **TC), eval_batch=16,
                        rounds_per_call=rounds_per_call)
    _, jhist = jtrainer.run(jax.random.PRNGKey(0), jdata, rounds=rounds,
                            eval_every=eval_every)
    data = make_federated_image_dataset(MNIST_LIKE, 4, device="cpu",
                                        num_samples=400, global_test=64,
                                        seed=0)
    trainer = FederatedTrainer(mlp[0], FedConfig(**fed), mlp[2],
                               eval_batch=16, device="cpu",
                               rounds_per_call=rounds_per_call)
    _, hist = trainer.run(data, rounds=rounds, eval_every=eval_every)
    assert hist["round"] == jhist["round"]


# --------------------------------------------------------------- durability
def test_resume_through_the_chunked_driver(mlp, tmp_path):
    """A checkpoint written after two chunks (round 6) resumes through the
    chunked driver bitwise as the unbroken single-round run."""
    data = mlp[1]
    fed = dict(num_malicious=1, attack="random_weights",
               participation=0.75, fault="dropout", fault_rate=0.2)
    whole, _ = _trainer(mlp, **fed).run(data, rounds=12, eval_every=12)
    mgr = CheckpointManager(str(tmp_path), save_every=6)
    first = _trainer(mlp, rounds_per_call=3, **fed)
    first.run(data, rounds=6, eval_every=6, ckpt=mgr)
    assert mgr.latest_step() == 6
    fresh = _trainer(mlp, rounds_per_call=3, **fed)
    restored, at = fresh.restore_checkpoint(mgr)
    assert at == 6
    resumed, hist = fresh.run(data, rounds=12, eval_every=12,
                              state=restored)
    assert hist["round"] == [9, 12]
    _assert_bitwise(whole, resumed)


def test_should_stop_ends_at_a_chunk_boundary(mlp):
    data = mlp[1]
    calls = []
    trainer = _trainer(mlp, rounds_per_call=3)

    def stop():
        calls.append(1)
        return len(calls) > 2
    state, hist = trainer.run(data, rounds=12, should_stop=stop)
    assert state.round_idx == 6 and hist["round"] == [3, 6]


# ------------------------------------------------ what the round reads
def test_eval_resampling_under_chunks(mlp):
    """Eval rows redrawn every 2 rounds, R = 2, participation 0.75: the
    bucket's rows are written into the static buffer before each replay
    whose bucket is new; bitwise the single rounds."""
    data = mlp[1]
    fed = dict(num_testers=3, participation=0.75)
    chunked = _trainer(mlp, rounds_per_call=2, eval_resample_every=2,
                       **fed)
    state, hist = chunked.run(data, rounds=5)
    assert hist["round"][-1] == 5 and chunked.chunk is not None
    assert chunked.chunk.bucket == (0, 1)   # rounds 2 and 3 were the last
    single = _trainer(mlp, eval_resample_every=2, **fed)
    _assert_bitwise(_singles(single, data, 5)[0], state)


def test_eval_rows_follow_the_seed_of_each_chunk(mlp):
    """One trainer chunks a state of seed 1, then one of seed 2 from the
    same round (the same eval bucket): the second chunk gathers seed 2's
    rows, not the rows its buffer held; each bitwise its single rounds."""
    data = mlp[1]
    fed = dict(num_testers=3, participation=0.75)
    chunked = _trainer(mlp, rounds_per_call=2, eval_resample_every=2,
                       **fed)
    single = _trainer(mlp, eval_resample_every=2, **fed)
    for seed in (1, 2):
        got, _ = chunked.run_chunk(chunked.init(seed=seed), data)
        assert chunked.chunk.bucket == (seed, 0)
        want, _ = _singles(single, data, 2, state=single.init(seed=seed))
        _assert_bitwise(want, got)


class _Seen:
    """Wraps a backend: keeps each round's tester ids and mask."""

    def __init__(self, backend):
        self.backend, self.ids, self.masks = backend, [], []

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def mask_models(self, models, global_params, part_mask):
        self.masks.append(part_mask.clone())
        return self.backend.mask_models(models, global_params, part_mask)

    def cross_test(self, eval_fn, models, tx, ty, tester_ids):
        self.ids.append(tester_ids.clone())
        return self.backend.cross_test(eval_fn, models, tx, ty, tester_ids)


@pytest.mark.parametrize("fed", [
    dict(selector="round_robin"),
    dict(selector="coverage"),
    dict(selector="fixed", selector_kwargs={"indices": (4, 1)}),
    dict(fault="targeted", fault_kwargs={"size": 2, "start_round": 5}),
    dict(selector="coverage", participation=0.5, fault="targeted",
         fault_kwargs={"size": 1, "placement": "first", "start_round": 3}),
], ids=["round_robin", "coverage", "fixed", "targeted",
        "coverage_targeted"])
def test_round_index_seams_across_chunk_boundaries(mlp, fed):
    """N = 6, K = 2 (a coverage cycle of 3 rounds), R = 4 over 9 rounds:
    chunks 0-3 and 4-7 cross cycles and the fault's start, then a single
    round. Every round's tester ids and mask are the single rounds'."""
    data = mlp[1]
    fed = dict(num_malicious=1, attack="sign_flip", **fed)
    runs = {}
    for r in (1, 4):
        trainer = _trainer(mlp, rounds_per_call=r, **fed)
        trainer.backend = _Seen(trainer.backend)
        state, _ = trainer.run(data, rounds=9)
        runs[r] = (state, trainer.backend)
    (s1, one), (s4, four) = runs[1], runs[4]
    assert len(one.ids) == len(four.ids) == 9
    assert all(torch.equal(a, b) for a, b in zip(one.ids, four.ids))
    assert len(one.masks) == len(four.masks)
    assert all(torch.equal(a, b) for a, b in zip(one.masks, four.masks))
    if "start_round" in fed.get("fault_kwargs", {}):
        start = fed["fault_kwargs"]["start_round"]
        size = fed["fault_kwargs"]["size"]
        assert all(m.sum() <= 6 - size for m in four.masks[start:])
    _assert_bitwise(s1, s4)


@pytest.mark.parametrize("name,kwargs", [
    ("round_robin", {}), ("coverage", {"seed": 3}),
    ("fixed", {"indices": (5, 0, 2)})])
def test_selectors_on_the_device_counter(name, kwargs):
    """Each selector's ids from a 0-d counter equal its ids from the host
    int, round by round across cycles (coverage from its schedule)."""
    sel = SELECTORS.build(name, kwargs)
    n, k, first, count = 7, 3, 5, 6
    sel.schedule(first, count, n, k, "cpu")
    counter = torch.zeros((), dtype=torch.int64)
    for r in range(first, first + count):
        counter.fill_(r)
        want = sel.select(None, n, k, r)
        got = sel.select(None, n, k, counter)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want), r


def test_targeted_fault_on_the_device_counter():
    fault = FAULTS.build("targeted", {"size": 2, "start_round": 3})
    counter = torch.zeros((), dtype=torch.int64)
    for r in range(6):
        counter.fill_(r)
        want = fault.mask(None, 5, r, device="cpu")
        assert torch.equal(fault.mask(None, 5, counter, device="cpu"), want)
        assert want.tolist() == ([1.0] * 5 if r < 3 else [1.0] * 3 + [0.0] * 2)


# ------------------------------------------------------------ the guards
def test_a_second_capture_raises(mlp):
    """One capture a trainer (its graph on the card): a second chunk
    reuses the first one's buffers, and a chunk on another dataset,
    which would need a second capture, is refused."""
    data = mlp[1]
    trainer = _trainer(mlp, rounds_per_call=2)
    state, _ = trainer.run_chunk(trainer.init(), data)
    captured = trainer.chunk
    state, _ = trainer.run_chunk(state, data)
    assert trainer.chunk is captured and state.round_idx == 4
    other = make_federated_image_dataset(MNIST_LIKE, 6, device="cpu",
                                         **SAMPLES)
    with pytest.raises(ValueError, match="dataset it was captured on"):
        trainer.run_chunk(state, other)
    assert trainer.chunk is captured


def test_rounds_per_call_below_one_is_refused(mlp):
    with pytest.raises(ValueError, match="rounds_per_call"):
        _trainer(mlp, rounds_per_call=0)


def test_cli_runs_chunks_on_the_cpu(tmp_path):
    """``--rounds-per-call 2`` over 5 rounds through the train CLI: the
    history at the chunk boundaries and the remainder."""
    train_mod.main([
        "--device", "cpu", "--arch", "fedtest-mlp-mnist", "--dataset",
        "mnist_like", "--users", "4", "--testers", "2", "--malicious", "1",
        "--rounds", "5", "--rounds-per-call", "2", "--samples", "600",
        "--local-steps", "2", "--batch", "8", "--out", str(tmp_path)])
    hist = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert hist["round"] == [2, 4, 5]
    assert hist["config"]["rounds_per_call"] == 2
    assert all(np.isfinite(hist["global_accuracy"]))


def test_lm_round_chunk_is_bitwise_single_rounds():
    """The LM round (``--dataset lm``, reduced qwen2-0.5b in f32) through
    the chunked driver: one chunk of 2 rounds == 2 single rounds."""
    argv = ["--device", "cpu", "--smoke", "--arch", "qwen2-0.5b",
            "--dataset", "lm", "--users", "3", "--testers", "2",
            "--malicious", "1", "--local-steps", "1", "--batch", "4",
            "--optimizer", "adamw", "--lr", "2e-3"]
    single, data, _ = train_mod.build(train_mod.parse_args(argv))
    chunked, _, _ = train_mod.build(train_mod.parse_args(
        argv + ["--rounds-per-call", "2"]))
    want, _ = _singles(single, data, 2)
    got, stacked = chunked.run_chunk(chunked.init(), data)
    assert stacked["weights"].shape == (2, 3)
    _assert_bitwise(want, got)
