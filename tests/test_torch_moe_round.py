"""The port's LM federated round on the moe and hybrid families, against
the reference.

As ``tests/test_torch_lm_round.py`` holds the dense and ssm rounds, on the
CPU at the reduced size (``reduce_for_smoke``: 2 layers, 4 experts top-2,
f32, a vocabulary of 97, sequences of 32 tokens), ``granite-moe-1b-a400m``
(two MoE layers) and ``jamba-1.5-large-398b`` (a mamba slot with a SwiGLU
FFN, an attention slot with a MoE):

* the LM ``make_eval_fn``'s ``[K, N]`` matrix against the reference's,
  the counts exact but where a near tie may flip one;
* one round with the reference's draws replayed: local training and the
  cross-test route the MoE by capacity, each (client) and (tester,
  model) instance over its own tokens under vmap, as the reference's
  vmap does; the counts exact as above; weights, scores, the malicious
  weight, the loss and the new global params, the f32 routers among
  them, at rtol 1e-4, atol 1e-5;
* training reaches neither kernel op; a cross-test calls
  ``flash_attention`` once an attention layer and ``ssd_scan`` once a
  mamba layer, whatever K and N;
* the example twin with a MoE arch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import FedConfig, TrainConfig  # noqa: E402
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch.train import make_lm_federated_dataset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from test_torch_lm_round import (  # noqa: E402
    BATCH, EVAL, K, N, PER_USER, SEQ, STEPS, VOCAB, _cfgs, _check_counts,
    _check_weights_scores_and_global, _eval_matrix, _replay_lm)

FAMILIES = ("moe", "hybrid")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("family", FAMILIES)
def test_moe_eval_matrix_matches_reference(family):
    """The dense test's check, with up to 1 % of a tester's 16 x 32 eval
    tokens (5) allowed to be near ties (the reference's top-two logits
    within 1e-4) rather than one: these random-init MoE models put 2 of
    them in one tester's row, where the counts still agree exactly."""
    _eval_matrix(family, max_ties=EVAL * SEQ // 100)


@pytest.fixture(scope="module")
def replayed_moe():
    return _replay_lm("moe")


@pytest.fixture(scope="module")
def replayed_hybrid():
    return _replay_lm("hybrid")


def _routers(params):
    return [slot["moe"]["router"] for slot in params["layers"].values()
            if "moe" in slot]


def test_one_moe_round_accuracy_counts_match_exactly(replayed_moe):
    _check_counts(replayed_moe)


def test_one_moe_round_weights_scores_and_global_match(replayed_moe):
    _check_weights_scores_and_global(replayed_moe)
    routers = _routers(replayed_moe["tnew"].global_params)
    assert len(routers) == 1 and routers[0].shape[0] == 2
    assert routers[0].dtype == torch.float32


def test_one_hybrid_round_accuracy_counts_match_exactly(replayed_hybrid):
    _check_counts(replayed_hybrid)


def test_one_hybrid_round_weights_scores_and_global_match(replayed_hybrid):
    """As the moe round, over the period stack: slot_0 (mamba, SwiGLU)
    and slot_1 (attention, MoE), the mamba block's f32 leaves and the
    router among the global params held."""
    _check_weights_scores_and_global(replayed_hybrid)
    layers = replayed_hybrid["tnew"].global_params["layers"]
    assert sorted(layers) == ["slot_0", "slot_1"]
    assert layers["slot_0"]["mamba"]["A_log"].dtype == torch.float32
    assert _routers(replayed_hybrid["tnew"].global_params)[0].dtype == (
        torch.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_moe_training_skips_the_kernel_ops_and_a_cross_test_folds(
        family, monkeypatch):
    """The ops' plain routes, counted: local training calls neither, a
    cross-test of K=2 testers over N=4 models calls ``flash_attention``
    once an attention layer and ``ssd_scan`` once a mamba layer (each
    folding K x N x rows into one batch), and so does the global eval."""
    _, tcfg = _cfgs(family)
    attn = sum(tcfg.uses_attention(i) for i in range(tcfg.num_layers))
    want = {"flash": attn, "ssd": tcfg.num_layers - attn}
    assert want == ({"flash": 2, "ssd": 0} if family == "moe"
                    else {"flash": 1, "ssd": 1})
    calls = {"flash": [], "ssd": []}
    attention_ref, ssd_ref = flash_ops.attention_ref, ssd_ops.ssd_ref
    monkeypatch.setattr(flash_ops, "attention_ref", lambda q, *a, **kw: (
        calls["flash"].append(tuple(q.shape)) or attention_ref(q, *a, **kw)))
    monkeypatch.setattr(ssd_ops, "ssd_ref", lambda x, *a, **kw: (
        calls["ssd"].append(tuple(x.shape)) or ssd_ref(x, *a, **kw)))
    data = make_lm_federated_dataset(VOCAB, N, seq_len=SEQ,
                                     seqs_per_user=PER_USER, device="cpu")
    trainer = FederatedTrainer(
        build_model(tcfg), FedConfig(num_users=N, num_testers=K,
                                     num_malicious=1, local_steps=STEPS),
        TrainConfig(optimizer="adamw", lr=2e-3, batch_size=BATCH),
        eval_batch=EVAL, device="cpu")
    seen = {}
    for step in ("train", "cross_test"):
        fn = getattr(trainer.backend, step)

        def counted(*a, fn=fn, step=step):
            before = {k: len(v) for k, v in calls.items()}
            out = fn(*a)
            seen[step] = {k: len(v) - before[k] for k, v in calls.items()}
            return out
        setattr(trainer.backend, step, counted)
    state, metrics = trainer.run_round(trainer.init(), data)
    assert seen["train"] == {"flash": 0, "ssd": 0}
    assert seen["cross_test"] == want
    for key in calls:
        assert all(shape[:2] == (K * N * EVAL, SEQ)
                   for shape in calls[key])
        calls[key].clear()
    acc = trainer.global_accuracy(state, data)
    assert {k: len(v) for k, v in calls.items()} == want
    assert 0.0 <= acc <= 1.0
    w = metrics["weights"]
    assert abs(float(w.sum()) - 1.0) < 1e-6 and bool(torch.isfinite(w).all())


def test_example_twin_runs_a_moe_arch():
    """The example's settings with ``--arch granite-moe-1b-a400m``: two
    rounds, finite accuracies and losses, a malicious weight in [0, 1],
    and a greedy continuation served (decode dropless)."""
    from repro_torch.examples.federated_llm import main
    trainer, state, hist, _ = main(["--device", "cpu", "--arch",
                                    "granite-moe-1b-a400m", "--malicious",
                                    "1", "--rounds", "2"])
    assert trainer.model.cfg.family == "moe"
    assert hist["round"] == [1, 2]
    assert all(np.isfinite(hist["global_accuracy"]))
    assert all(np.isfinite(hist["local_loss"]))
    assert all(0.0 <= w <= 1.0 for w in hist["malicious_weight"])
