"""The pod round of the port (one client a rank of a ``torch.distributed``
group; ``repro_torch.core.engine.backends``) on the CPU: four gloo ranks,
all cases of this file in one spawned group (``_torch_pod_ranks``).

* the reference's backend matrix (``tests/test_pod_parity.py``'s
  ``CASES``: attacks x participation x coalitions x selectors x faults x
  crosstest impl), 3 rounds each, plus ``trimmed_mean_coord`` and
  ``krum`` (the update matrix) and ``int8`` / ``topk`` (the compressed
  exchange): ring == allgather bitwise (params, scores, weights, the
  malicious weight, the generator); each pod run against the port's
  ``LocalBackend`` on the same draws, the ``[K, N]`` counts and every
  discrete field exactly, the scores and weights bitwise, the params
  within rtol 1e-5 / atol 1e-6 (one client's convolution and a vmapped
  one may round differently);
* ``batched`` == ``reference`` on both exchanges, bitwise;
* the error feedback replicated identically on every rank;
* ``Attack.apply_local`` against slot c of ``Attack.apply``, and the
  builders' refusals (``tests/test_distributed.py``).

The resume runs and a failing rank play in
``tests/test_torch_pod_resume.py``, to keep this file's one group short.

Torch runs one thread a process.
"""
import concurrent.futures
import inspect
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_pod_ranks as ranks  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

ROUNDS = 3
PARAMS = dict(rtol=1e-5, atol=1e-6)
# (attack, participation, coalition, selector, fault, crosstest_impl),
# the reference pod matrix's rows
CASES = [("none", 1.0, "none", "rotating", "none", "batched"),
         ("none", 0.75, "none", "rotating", "none", "batched"),
         ("sign_flip", 1.0, "none", "rotating", "none", "batched"),
         ("sign_flip", 0.75, "none", "rotating", "none", "batched"),
         ("adaptive_scale", 1.0, "none", "rotating", "none", "batched"),
         ("adaptive_scale", 0.75, "none", "rotating", "none", "batched"),
         ("none", 1.0, "mutual_boost", "rotating", "none", "batched"),
         ("none", 0.75, "mutual_boost", "rotating", "none", "batched"),
         ("none", 1.0, "sybil_split", "rotating", "none", "batched"),
         ("none", 0.75, "sybil_split", "rotating", "none", "batched"),
         ("none", 1.0, "mutual_boost", "score_weighted", "none",
          "batched"),
         ("none", 0.75, "none", "coverage", "none", "batched"),
         ("none", 1.0, "none", "rotating", "dropout", "batched"),
         ("sign_flip", 0.75, "none", "rotating", "dropout", "batched"),
         ("none", 1.0, "none", "rotating", "straggler_deadline",
          "batched"),
         ("none", 1.0, "none", "rotating", "none", "reference"),
         ("sign_flip", 0.75, "none", "rotating", "none", "reference"),
         ("none", 1.0, "none", "rotating", "dropout", "reference")]
# rows that differ only in the crosstest impl
IMPL_PAIRS = ["none|1.0|none|rotating|none",
              "sign_flip|0.75|none|rotating|none",
              "none|1.0|none|rotating|dropout"]


def _fed(attack, participation, coalition, selector, fault, impl):
    return dict(num_users=ranks.N,
                num_testers=ranks.N if selector == "rotating" else 3,
                num_malicious=0 if attack == "none" else 1,
                attack=attack, attack_scale=4.0, coalition=coalition,
                coalition_size=0 if coalition == "none" else 2,
                selector=selector, fault=fault, fault_rate=0.25,
                participation=participation, local_steps=2,
                crosstest_impl=impl, seed=0)


_SIGN_FLIP = _fed("sign_flip", 0.75, "none", "rotating", "none", "batched")
FEDS = {"|".join(map(str, c)): _fed(*c) for c in CASES}
FEDS.update({
    # the update matrix: the coordinate-wise combine and Krum's ctx.updates
    "trimmed_mean_coord": dict(_SIGN_FLIP, aggregator="trimmed_mean_coord"),
    "krum": dict(_SIGN_FLIP, aggregator="krum"),
    # the compressed exchange
    "int8": dict(_SIGN_FLIP, compressor="int8"),
    "topk": dict(_SIGN_FLIP, compressor="topk",
                 compressor_kwargs={"k": 0.05}),
})
COMPRESSED = ("int8", "topk")


@pytest.fixture(scope="module")
def runs():
    """Every pod run on one group of four ranks, and meanwhile every local
    run here: ``(pod, local)``, ``pod[rank][(case, exchange)]``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            pod = pool.submit(run_ranks, ranks.matrix_rank, ranks.N, FEDS,
                              ROUNDS, threads=1, timeout_s=120,
                              join_timeout_s=300)
            data = ranks.dataset()
            local = {name: ranks.play(ranks.local_trainer(fed), data,
                                      ROUNDS)[0]
                     for name, fed in FEDS.items()}
            return pod.result(), local
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(FEDS))
def test_ring_equals_allgather_bitwise(runs, case):
    pod, _ = runs
    ranks.same_run(pod[0][case, "ring"], pod[0][case, "allgather"], case)


# the metrics that are discrete or come from the [K, N] counts alone
EXACT = ("weights", "scores", "malicious_weight", "participation_rate",
         "dropped_fraction", "acc_matrix_mean")


@pytest.mark.parametrize("exchange", ["ring", "allgather"])
@pytest.mark.parametrize("case", list(FEDS))
def test_pod_matches_the_local_backend(runs, case, exchange):
    """Counts, discrete fields, scores and weights exactly; the params,
    the losses and the error feedback within rtol 1e-5 / atol 1e-6."""
    pod, local = runs
    got, want = pod[0][case, exchange], local[case]
    counts = [np.rint(a * ranks.EVAL).astype(np.int64) for a in got["acc"]]
    want_counts = [np.rint(a * ranks.EVAL).astype(np.int64)
                   for a in want["acc"]]
    ranks.bitwise(counts, want_counts,
                  f"{case} {exchange}: [K, N] counts")
    for r, (m, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in EXACT:
            np.testing.assert_array_equal(
                m[k], w[k], err_msg=f"{case} {exchange} round {r}: {k}")
        np.testing.assert_allclose(m["local_loss"], w["local_loss"],
                                   **PARAMS)
    ranks.bitwise(got["scores"], want["scores"],
                  f"{case} {exchange}: scores")
    np.testing.assert_array_equal(got["gen"], want["gen"],
                                  f"{case} {exchange}: generator")
    for p, q in zip(got["params"], want["params"]):
        np.testing.assert_allclose(p, q, **PARAMS)
    if want["comp"] is not None:
        np.testing.assert_allclose(got["comp"], want["comp"], **PARAMS)


@pytest.mark.parametrize("exchange", ["ring", "allgather"])
@pytest.mark.parametrize("pair", IMPL_PAIRS)
def test_batched_equals_reference_bitwise(runs, pair, exchange):
    pod, _ = runs
    ranks.same_run(pod[0][f"{pair}|batched", exchange],
              pod[0][f"{pair}|reference", exchange], f"{pair} {exchange}")


@pytest.mark.parametrize("exchange", ["ring", "allgather"])
@pytest.mark.parametrize("case", COMPRESSED)
def test_every_rank_holds_the_same_state(runs, case, exchange):
    """The replicated state — the error feedback, the params, the scores
    and the generator — is bitwise the same on every rank."""
    pod, _ = runs
    first = pod[0][case, exchange]
    assert first["comp"] is not None and first["comp"].any()
    for rank in range(1, ranks.N):
        ranks.same_run(first, pod[rank][case, exchange],
                       f"{case} rank {rank}")


def test_the_cases_engage_the_adversary(runs):
    """The attack and the coalitions move the weights off the honest run,
    and the faults drop someone, as the reference's matrix checks."""
    _, local = runs
    honest = local["none|1.0|none|rotating|none|batched"]["metrics"]
    for case in ("sign_flip|1.0|none|rotating|none|batched",
                 "none|1.0|mutual_boost|rotating|none|batched",
                 "none|1.0|sybil_split|rotating|none|batched"):
        run = local[case]["metrics"]
        assert any(not np.array_equal(a["weights"], b["weights"])
                   for a, b in zip(run, honest)), case
        assert any(m["malicious_weight"] > 0 for m in run), case
    for fault in ("dropout", "straggler_deadline"):
        run = local[f"none|1.0|none|rotating|{fault}|batched"]["metrics"]
        assert any(m["dropped_fraction"] > 0 for m in run), fault


# ----------------------------------------------- one client's corruption
ATTACK_NAMES = ("none", "random_weights", "sign_flip", "label_flip_proxy",
                "scaled_update", "adaptive_scale", "scaled_collusion",
                "sybil_split")


def test_every_attack_is_covered():
    from repro_torch.strategies import ATTACKS
    assert set(ATTACKS.names()) == set(ATTACK_NAMES) - {"sybil_split"}


@pytest.mark.parametrize("name", ATTACK_NAMES)
def test_apply_local_is_slot_c_of_apply(name):
    """Each client's ``apply_local`` is bitwise slot c of ``apply`` on the
    stack, from the same noise; an honest client keeps its params."""
    from repro_torch.config import FedConfig
    from repro_torch.core.engine import resolve_coalition
    from repro_torch.strategies import ATTACKS
    from repro_torch.strategies.base import AttackContext
    from repro_torch.utils import tree_leaves, tree_map

    n = 5
    gen = torch.Generator().manual_seed(0)
    g = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "b": torch.ones((3,))}
    stacked = tree_map(lambda x: x[None] + 0.1 * torch.randn(
        (n,) + x.shape, generator=gen), g)
    base = "none" if name == "sybil_split" else name
    atk = ATTACKS.build(base, {"placement": "first"},
                        {"num_malicious": 2, "scale": 1.5})
    if name == "sybil_split":
        atk = resolve_coalition(FedConfig(
            num_users=n, coalition="sybil_split", coalition_size=2,
            attack_scale=3.0)).compose(atk, n)
    scores = torch.rand((n,), generator=gen)
    ctx = AttackContext(scores=scores, weights=scores / scores.sum(),
                        round_idx=2)
    noise = {c: [torch.randn(t.shape, generator=gen)
                 for t in tree_leaves(g)]
             for c in atk.malicious_indices(n)} if atk.needs_noise else None
    applied = atk.apply(noise, stacked, g, ctx)
    for c in range(n):
        trained = tree_map(lambda t, c=c: t[c], stacked)
        local = atk.apply_local(noise, trained, g, c, n, ctx)
        want = tree_map(lambda t, c=c: t[c], applied)
        ranks.bitwise([t.numpy() for t in tree_leaves(local)],
                 [t.numpy() for t in tree_leaves(want)], f"{name} client {c}")
        if c not in atk.malicious_indices(n):
            assert all(a is b for a, b in zip(tree_leaves(local),
                                              tree_leaves(trained)))


# ------------------------------------------------------------- refusals
def _fake_group(world_size=4):
    """A group's shape without a process group: the builders check it
    before any collective."""
    return types.SimpleNamespace(rank=0, world_size=world_size,
                                 device=torch.device("cpu"))


REFUSALS = {
    "world_size": (dict(num_users=8, num_testers=4), {}, "num_users"),
    "server_data": (dict(num_users=4, num_testers=4,
                         aggregator="accuracy_based"), {}, "server"),
    "exchange": (dict(num_users=4, num_testers=4), {"exchange": "mesh"},
                 "exchange"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_make_pod_round_refuses(case):
    from repro_torch.config import FedConfig
    from repro_torch.core.distributed import make_pod_round
    fed, kw, match = REFUSALS[case]
    model, tc = ranks.model_and_train()
    with pytest.raises(ValueError, match=match):
        make_pod_round(model, FedConfig(**fed), tc, _fake_group(), **kw)


def test_the_builders_run_the_named_exchange():
    from repro_torch.config import FedConfig
    from repro_torch.core.distributed import (
        make_allgather_round, make_distributed_round)
    from repro_torch.core.engine import AllgatherBackend, RingBackend
    model, tc = ranks.model_and_train()
    fed = FedConfig(num_users=4, num_testers=4, compressor="int8")
    ring = make_distributed_round(model, fed, tc, _fake_group())
    gather = make_allgather_round(model, fed, tc, _fake_group())
    assert type(ring.backend) is RingBackend
    assert type(gather.backend) is AllgatherBackend
    # the compressed signature carries the error feedback
    assert list(inspect.signature(ring).parameters)[:3] == [
        "global_params", "scores", "comp"]


@pytest.mark.parametrize("device_type,backend,match", [
    ("cpu", "nccl", "needs CUDA"),
    ("cuda", "nccl", "one rank a card"),
])
def test_dist_backend_refusals(device_type, backend, match):
    """nccl never runs ranks on the CPU, nor more ranks than cards (this
    machine has none)."""
    from repro_torch.launch.mesh import resolve_dist_backend
    with pytest.raises(ValueError, match=match):
        resolve_dist_backend(device_type, backend, 4)


def test_pod_trainer_and_sharded_population_refusals():
    from repro_torch.core.engine import PodTrainer, PopulationBackend
    model, tc = ranks.model_and_train()
    from repro_torch.config import FedConfig
    with pytest.raises(ValueError, match="one round a call"):
        PodTrainer(model, FedConfig(num_users=4, num_testers=4), tc,
                   group=_fake_group(), rounds_per_call=2)
    with pytest.raises(ValueError, match="divide evenly"):
        PopulationBackend(64, 8, group=_fake_group(3))
