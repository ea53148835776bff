"""The paper's round in the port beyond its main path, against the
reference: the round math (``core/aggregation.py``, ``eval/metrics.py``),
the remaining strategies (``accuracy_based``, ``label_flip_proxy``,
``adaptive_scale``, the four selectors), the cross-testing options
(``crosstest_impl``, eval-batch resampling), the server split, the
registries, the train CLI's flags and the two example twins.

Randomness is replayed where the two packages would draw differently:
``coverage``'s permutation, ``score_weighted``'s uniforms and the eval
batches' uniforms are the reference's, fed into the port's pure steps.
Ids and counts must match exactly; floats at 1e-6.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import cross_testing as jcross  # noqa: E402
from repro.core.engine.program import (  # noqa: E402
    resolve_strategies as j_resolve)
from repro.data import MNIST_LIKE as J_MNIST  # noqa: E402
from repro.data import make_federated_image_dataset as jmake_data  # noqa: E402
from repro.eval import metrics as jmetrics  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.strategies import ATTACKS as JATTACKS  # noqa: E402
from repro.strategies import SELECTORS as JSELECTORS  # noqa: E402
from repro.strategies.base import AttackContext as JAttackContext  # noqa: E402
from repro.utils.pytree import tree_add_vector as j_tree_add  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FederatedTrainer, accuracy_based_weights, aggregate_models,
    fedavg_weights, make_eval_fn)
from repro_torch.core.cross_testing import (  # noqa: E402
    EVAL_BATCH_STREAM, eval_batch_indices, eval_indices_from_uniforms,
    sampled_eval_batches)
from repro_torch.core.engine import LocalBackend  # noqa: E402
from repro_torch.core.engine.program import resolve_strategies  # noqa: E402
from repro_torch.data import (  # noqa: E402
    MNIST_LIKE, gather_client_batches, make_federated_image_dataset)
from repro_torch.eval import classify_accuracy, evaluate_classifier  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.strategies import (  # noqa: E402
    AGGREGATORS, ATTACKS, COALITIONS, COMPRESSORS, FAULTS, SELECTORS)
from repro_torch.strategies.base import AttackContext  # noqa: E402
from repro_torch.strategies.selectors import (  # noqa: E402
    coverage_ids, score_weighted_ids)
from repro_torch.utils import tree_leaves  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = dict(cnn_channels=(8, 16, 16), cnn_hidden=32)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"conv0": {"b": rng.standard_normal(lead + (4,)).astype(np.float32),
                      "w": rng.standard_normal(lead + (3, 3, 2, 4))
                      .astype(np.float32)},
            "fc1": {"b": rng.standard_normal(lead + (5,)).astype(np.float32),
                    "w": (3.0 * rng.standard_normal(lead + (6, 5)))
                    .astype(np.float32)}}


def _ttree(tree):
    return {k: {n: _t(a) for n, a in v.items()} for k, v in tree.items()}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_trees_close(got, want, **tol):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **(tol or dict(rtol=1e-6, atol=1e-6)))


# ------------------------------------------------------------- round math
@pytest.mark.parametrize("counts", [[120, 40, 0, 77, 300], [0, 0, 0]])
def test_fedavg_weights_match_reference(counts):
    c = np.asarray(counts, np.int32)
    np.testing.assert_allclose(fedavg_weights(_t(c)).numpy(),
                               np.asarray(jagg.fedavg_weights(jnp.asarray(c))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("power", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("case", ["spread", "out_of_range", "all_zero"])
def test_accuracy_based_weights_match_reference(power, case):
    rng = np.random.default_rng(int(power))
    acc = {"spread": rng.uniform(size=7),
           "out_of_range": rng.uniform(-0.2, 1.3, size=7),
           "all_zero": np.zeros(7)}[case].astype(np.float32)
    got = accuracy_based_weights(_t(acc), power).numpy()
    want = np.asarray(jagg.accuracy_based_weights(jnp.asarray(acc), power))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sum(), 1.0, atol=1e-6)
    if case == "all_zero":
        np.testing.assert_array_equal(got, np.full(7, 1 / 7, np.float32))


def test_aggregate_models_weighted_sum_matches_reference():
    stacked = _tree(0, lead=(5,))
    w = np.random.default_rng(1).dirichlet(np.ones(5)).astype(np.float32)
    got = aggregate_models(_ttree(stacked), _t(w))
    want = jagg.aggregate_models(_jtree(stacked), jnp.asarray(w), impl="naive")
    _assert_trees_close(got, want)


def test_aggregate_models_combine_branch_matches_reference():
    """The combine branch: ``combine_fn`` maps the [N, D] update matrix to
    one [D] update, scattered onto the global params."""
    from repro.core.engine.backends import _flatten_updates as j_flatten
    from repro_torch.core.engine.backends import _flatten_updates
    stacked, g = _tree(2, lead=(4,)), _tree(3)
    updates = _flatten_updates(_ttree(stacked), _ttree(g))
    jupdates = j_flatten(_jtree(stacked), _jtree(g))
    w = _t(np.full(4, 0.25, np.float32))
    got = aggregate_models(
        _ttree(stacked), w, combine_fn=lambda u: u.median(dim=0).values,
        updates=updates, global_params=_ttree(g))
    want = jagg.aggregate_models(
        _jtree(stacked), jnp.asarray(w.numpy()),
        combine_fn=lambda u: jnp.sort(u, axis=0)[1],   # lower middle of 4
        updates=jupdates, global_params=_jtree(g))
    _assert_trees_close(got, want)
    _assert_trees_close(
        got, j_tree_add(_jtree(g), jnp.sort(jupdates, axis=0)[1]))


def test_aggregate_models_combine_needs_updates_and_global():
    stacked = _ttree(_tree(4, lead=(3,)))
    with pytest.raises(ValueError, match="updates matrix"):
        aggregate_models(stacked, _t(np.ones(3, np.float32) / 3),
                         combine_fn=lambda u: u.mean(dim=0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classify_accuracy_matches_reference(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((200, 10)).astype(np.float32)
    logits[:20] = 0.0                    # all tied: argmax is index 0
    labels = rng.integers(0, 10, size=200).astype(np.int32)
    labels[:10] = 0
    got = classify_accuracy(_t(logits), _t(labels))
    want = jmetrics.classify_accuracy(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), abs=1e-7)


@pytest.fixture(scope="module")
def small_cnn():
    """The reduced MNIST CNN in both packages, the port holding the
    reference's init, and 300 global samples of the shared shards."""
    jmodel = jbuild_model(jget_config("fedtest-cnn-mnist").replace(**SMALL))
    tmodel = build_model(get_config("fedtest-cnn-mnist").replace(**SMALL))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tparams = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu", model=tmodel)
    data = make_federated_image_dataset(MNIST_LIKE, 4, num_samples=800,
                                        global_test=300, seed=2,
                                        device="cpu")
    return jmodel, jparams, tmodel, tparams, data


@pytest.mark.parametrize("batch", [7, 128, 512])
def test_evaluate_classifier_matches_reference(small_cnn, batch):
    jmodel, jparams, tmodel, tparams, data = small_cnn
    x, y = data.global_x, data.global_y
    got = evaluate_classifier(tmodel, tparams, x, y, batch=batch)
    want = jmetrics.evaluate_classifier(jmodel, jparams, jnp.asarray(x),
                                        jnp.asarray(y), batch=batch)
    logits = np.sort(np.asarray(jmodel.forward_train(
        jparams, {"images": jnp.asarray(x)})[0]), -1)
    ties = int((logits[:, -1] - logits[:, -2] < 1e-4).sum())
    assert abs(got - want) * len(y) <= ties + 1e-9, (got, want, ties)
    # the batched loop is the one-shot accuracy within the port
    whole = classify_accuracy(tmodel.forward_train(tparams, {"images": x}), y)
    assert round(got * len(y)) == round(float(whole) * len(y))


# --------------------------------------------------------------- selectors
@pytest.mark.parametrize("n,k", [(6, 2), (20, 5), (7, 3), (5, 5)])
def test_round_robin_matches_reference(n, k):
    j = JSELECTORS.build("round_robin")
    t = SELECTORS.build("round_robin")
    for r in range(3 * n):
        want = np.asarray(j.select(None, n, k, r))
        got = t.select(None, n, k, r)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("indices", [None, (4, 1, 3)])
def test_fixed_matches_reference(indices):
    kw = {} if indices is None else {"indices": indices}
    j, t = JSELECTORS.build("fixed", kw), SELECTORS.build("fixed", kw)
    for r in range(10):
        np.testing.assert_array_equal(t.select(None, 6, 3, r).numpy(),
                                      np.asarray(j.select(None, 6, 3, r)))
    if indices is not None:
        for sel in (j, t):
            with pytest.raises(ValueError, match="num_testers"):
                sel.select(None, 6, 2, 0)


@pytest.mark.parametrize("n,k,seed", [(6, 2, 0), (20, 5, 3), (7, 3, 11)])
def test_coverage_matches_reference_on_its_permutation(n, k, seed):
    """The slicing step fed the reference's per-cycle permutation gives
    the reference's ids, round for round, across cycles and the wrap."""
    j = JSELECTORS.build("coverage", {"seed": seed})
    cycle_len = -(-n // k)
    for r in range(3 * cycle_len):
        perm = jax.random.permutation(
            jax.random.fold_in(jax.random.PRNGKey(seed), r // cycle_len), n)
        got = coverage_ids(_t(perm), r, k).numpy()
        np.testing.assert_array_equal(got, np.asarray(j.select(None, n, k,
                                                               r)))


@pytest.mark.parametrize("n,k", [(6, 2), (20, 5), (7, 3), (10, 1)])
def test_coverage_cycle_covers_every_id(n, k):
    """Every cycle of ceil(N/K) rounds tests every client, the schedule
    depends on the seed alone (not on the round's generator, which it
    leaves untouched), and two cycles differ."""
    sel = SELECTORS.build("coverage", {}, {"seed": 5})
    cycle_len = -(-n // k)
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    cycles = []
    for c in range(4):
        ids = [sel.select(gen, n, k, c * cycle_len + p)
               for p in range(cycle_len)]
        assert all(i.dtype == torch.int32 and len(set(i.tolist())) == k
                   for i in ids)
        assert set(torch.cat(ids).tolist()) == set(range(n))
        cycles.append(torch.cat(ids).tolist())
    assert torch.equal(gen.get_state(), before)
    again = SELECTORS.build("coverage", {"seed": 5})
    assert again.select(None, n, k, 1).tolist() == cycles[0][k:2 * k]
    if n > 3:
        assert len({tuple(c) for c in cycles}) > 1


@pytest.mark.parametrize("case", ["none", "spread", "zeros", "peaked"])
def test_score_weighted_matches_reference_on_its_uniforms(case):
    """The Gumbel top-k fed the reference's uniforms picks the reference's
    ids wherever no two of the top K + 1 keys are within 1e-5 relative
    (``top_k`` and ``torch.topk`` may break a tie differently)."""
    n, k, eps = 12, 4, 1e-3
    j = JSELECTORS.build("score_weighted", {"eps": eps})
    held = 0
    for seed in range(20):
        rng = np.random.default_rng(seed)
        scores = {"none": None, "spread": rng.uniform(size=n),
                  "zeros": np.zeros(n),
                  "peaked": np.where(rng.uniform(size=n) < 0.3, 0.9, 0.01)
                  }[case]
        if scores is not None:
            scores = scores.astype(np.float32)
        key = jax.random.PRNGKey(seed)
        u = jax.random.uniform(key, (n,), minval=1e-12, maxval=1.0)
        want = np.asarray(j.select(
            key, n, k, 0, scores=None if scores is None
            else jnp.asarray(scores)))
        got = score_weighted_ids(None if scores is None else _t(scores),
                                 _t(u), k, eps).numpy()
        p = (np.ones(n) if scores is None
             else np.maximum(scores, 0.0) + eps).astype(np.float32)
        keys = np.sort(np.log(p) - np.log(-np.log(np.asarray(u))))[::-1]
        gaps = np.abs(np.diff(keys[:k + 1])) / np.maximum(
            np.abs(keys[:k]), 1e-30)
        if (gaps > 1e-5).all():
            np.testing.assert_array_equal(got, want)
            held += 1
    assert held >= 15, held


def test_score_weighted_draws_from_the_round_generator():
    sel = SELECTORS.build("score_weighted")
    scores = torch.tensor([0.0, 0.9, 0.9, 0.0, 0.9, 0.0, 0.0, 0.9])
    picks = []
    for seed in (1, 1, 2):
        gen = torch.Generator().manual_seed(seed)
        ids = sel.select(gen, 8, 4, 0, scores=scores)
        assert ids.dtype == torch.int32 and len(set(ids.tolist())) == 4
        picks.append(ids.tolist())
    assert picks[0] == picks[1]
    # with eps=1e-3 the four trusted clients hold almost all the mass
    assert sorted(picks[0]) == [1, 2, 4, 7]
    with pytest.raises(ValueError, match="eps"):
        SELECTORS.build("score_weighted", {"eps": 0.0})


# ----------------------------------------------------------------- attacks
def test_label_flip_proxy_matches_reference():
    """A unit-scale sign-flip, whatever scale the registry offers."""
    defaults = dict(num_malicious=2, scale=5.0)
    j = JATTACKS.build("label_flip_proxy", {}, defaults)
    t = ATTACKS.build("label_flip_proxy", {}, defaults)
    assert t.scale == j.scale == 1.0
    assert t.malicious_indices(6) == j.malicious_indices(6) == (4, 5)
    trained, g = _tree(5), _tree(6)
    _assert_trees_close(t.corrupt(None, _ttree(trained), _ttree(g)),
                        j.corrupt(None, _jtree(trained), _jtree(g)))


@pytest.mark.parametrize("case", ["engaged", "disengaged", "no_context"])
def test_adaptive_scale_matches_reference(case):
    """Sign-flip at ``scale`` while the attacker's weight is at least
    ``weight_threshold / N``, else the honest model; without a context an
    unconditional sign-flip."""
    n, c = 6, 5
    kw, defaults = {"weight_threshold": 0.5}, dict(num_malicious=1,
                                                   scale=3.0)
    j = JATTACKS.build("adaptive_scale", kw, defaults)
    t = ATTACKS.build("adaptive_scale", kw, defaults)
    w = np.full(n, 1.0 / n, np.float32)
    w[c] = {"engaged": 0.5 / n, "disengaged": 0.49 / n,
            "no_context": 0.0}[case]
    w[0] += 1.0 - w.sum()
    s = np.random.default_rng(7).uniform(size=n).astype(np.float32)
    jctx = tctx = None
    if case != "no_context":
        jctx = JAttackContext(jnp.asarray(s), jnp.asarray(w), jnp.asarray(2))
        tctx = AttackContext(_t(s), _t(w), 2)
    trained, g = _tree(8), _tree(9)
    got = t.corrupt(None, _ttree(trained), _ttree(g), tctx, c)
    want = j.corrupt(None, _jtree(trained), _jtree(g), jctx, c)
    _assert_trees_close(got, want)
    honest = all(torch.equal(a, b) for a, b in
                 zip(tree_leaves(got), tree_leaves(_ttree(trained))))
    assert honest == (case == "disengaged")


def test_adaptive_scale_decides_on_the_device(monkeypatch):
    """The engage choice is a tensor op: the weight is never read back to
    the host (no bool, float or item of a tensor), so a round on the card
    does not wait for it."""
    def host_read(*_):
        raise AssertionError("a tensor was read on the host")
    atk = ATTACKS.build("adaptive_scale", {}, dict(num_malicious=1))
    ctx = AttackContext(torch.zeros(4), torch.full((4,), 0.25), 0)
    trained, g = _ttree(_tree(10)), _ttree(_tree(11))
    for name in ("__bool__", "__float__", "__int__", "item"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    got = atk.corrupt(None, trained, g, ctx, 3)
    monkeypatch.undo()
    assert not torch.equal(tree_leaves(got)[0], tree_leaves(trained)[0])


# -------------------------------------------------- cross-testing options
@pytest.mark.parametrize("bucket", [0, 1, 7])
def test_eval_batch_indices_match_reference_on_its_uniforms(bucket):
    counts = np.array([37, 5, 120, 1, 64], np.int32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jcross.eval_batch_indices(key, jnp.asarray(counts), 48,
                                                bucket))
    k = jax.random.fold_in(jax.random.fold_in(key, EVAL_BATCH_STREAM),
                           bucket)
    u = jax.random.uniform(k, (5, 48))
    got = eval_indices_from_uniforms(_t(u), _t(counts))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < counts[:, None]).all()


def test_eval_batches_follow_the_bucket_rule():
    """Rounds 0 and 1 share their eval rows, round 2 draws new ones; the
    rows are a pure function of (run seed, bucket) and leave the round's
    generator, so the other draws are those of a fixed-prefix run."""
    counts = _t(np.array([30, 12, 50, 7], np.int32))
    idx = [eval_batch_indices(0, counts, 16, r // 2) for r in range(3)]
    assert torch.equal(idx[0], idx[1]) and not torch.equal(idx[1], idx[2])
    assert torch.equal(idx[2], eval_batch_indices(0, counts, 16, 1))
    assert not torch.equal(idx[0], eval_batch_indices(1, counts, 16, 0))
    assert (idx[2] < counts[:, None]).all() and (idx[2] >= 0).all()

    model = build_model(get_config("fedtest-cnn-mnist").replace(**SMALL))
    data = make_federated_image_dataset(MNIST_LIKE, 4, num_samples=800,
                                        global_test=100, seed=0,
                                        device="cpu")
    fed = FedConfig(num_users=4, num_testers=2, local_steps=1, seed=3)
    tc = TrainConfig(optimizer="sgd", lr=0.1, schedule="constant",
                     batch_size=8, grad_clip=0.0)
    draws = {}
    for every in (0, 2):
        trainer = FederatedTrainer(model, fed, tc, eval_batch=16,
                                   device="cpu", eval_resample_every=every)
        state = trainer.init()
        assert state.seed == 3
        draws[every] = []
        for r in range(3):
            draws[every].append(trainer.draw(state._replace(round_idx=r),
                                             data))
    for plain, resampled in zip(draws[0], draws[2]):
        assert plain.eval_idx is None
        assert torch.equal(plain.batch_idx, resampled.batch_idx)
        assert torch.equal(plain.tester_ids, resampled.tester_ids)
    got = [d.eval_idx for d in draws[2]]
    assert torch.equal(got[0], got[1]) and not torch.equal(got[1], got[2])
    assert torch.equal(got[2], eval_batch_indices(3, data.test.counts, 16, 1))
    tx, ty = trainer.eval_batches(data, draws[2][2])
    rows = torch.arange(4)[:, None]
    assert torch.equal(tx, data.test.xs[rows, got[2]])
    sx, sy = sampled_eval_batches(3, data.test, 16, 2, 2)
    assert torch.equal(sx, tx) and torch.equal(sy, ty)


def test_crosstest_impls_are_bitwise_equal_within_the_port():
    model = build_model(get_config("fedtest-cnn-mnist").replace(**SMALL))
    data = make_federated_image_dataset(MNIST_LIKE, 5, num_samples=800,
                                        global_test=100, seed=1,
                                        device="cpu")
    gen = torch.Generator().manual_seed(2)
    stacked = {k: {n: torch.stack([model.init(gen)[k][n] for _ in range(5)])
                   for n in ("w", "b")} for k in model.param_shapes()}
    ids = torch.tensor([3, 0], dtype=torch.int32)
    tx, ty = data.test.xs[:, :24], data.test.ys[:, :24]
    eval_fn = make_eval_fn(model)
    out = {impl: LocalBackend(5, impl).cross_test(eval_fn, stacked, tx, ty,
                                                  ids)
           for impl in ("batched", "reference")}
    assert out["batched"].shape == (2, 5)
    assert torch.equal(out["batched"], out["reference"])
    with pytest.raises(ValueError, match="crosstest_impl"):
        LocalBackend(5, "fused")
    fed = FedConfig(num_users=5, num_testers=2, crosstest_impl="reference")
    tc = TrainConfig()
    assert FederatedTrainer(model, fed, tc, device="cpu"
                            ).backend.crosstest_impl == "reference"
    assert FederatedTrainer(model, fed, tc, device="cpu",
                            crosstest_impl="batched"
                            ).backend.crosstest_impl == "batched"
    with pytest.raises(ValueError, match="crosstest_impl"):
        FedConfig(crosstest_impl="fused")


@pytest.mark.parametrize("server_frac", [0.1, 0.25, 0.0])
def test_server_split_is_bitwise_the_reference(server_frac):
    kw = dict(num_samples=500, global_test=60, seed=4, server_frac=server_frac,
              partition_kwargs={"min_classes": 3})
    ref = jmake_data(J_MNIST, 4, **kw)
    got = make_federated_image_dataset(MNIST_LIKE, 4, device="cpu", **kw)
    assert got.server_x.shape[0] == int(500 * server_frac)
    for t, j in ((got.server_x, ref.server_x), (got.server_y, ref.server_y),
                 (got.train.xs, ref.train.xs), (got.test.ys, ref.test.ys)):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)


def test_server_test_fraction_is_inert_in_both_packages():
    """Nothing reads the field, in the reference either: the builder takes
    its own ``server_frac`` and the CLI never passes the field."""
    import inspect
    from repro.data import builders as jbuilders
    from repro_torch.data import builders
    for mod in (jbuilders, builders):
        sig = inspect.signature(mod.make_federated_image_dataset)
        assert sig.parameters["server_frac"].default == 0.1
    assert FedConfig(server_test_fraction=0.3).server_test_fraction == 0.3
    assert JFedConfig().server_test_fraction == FedConfig(
    ).server_test_fraction


# ----------------------------------------------------------- registries
README_NAMES = {
    "AGGREGATORS": ("fedtest", "fedavg", "accuracy_based", "krum",
                    "trimmed_mean", "median", "trimmed_mean_coord",
                    "median_coord", "uniform"),
    "ATTACKS": ("none", "random_weights", "sign_flip", "label_flip_proxy",
                "scaled_update", "adaptive_scale", "scaled_collusion"),
    "SELECTORS": ("rotating", "uniform", "round_robin", "coverage",
                  "score_weighted", "fixed"),
    "COALITIONS": ("none", "mutual_boost", "sybil_split", "full_collusion"),
    "FAULTS": ("none", "dropout", "straggler_deadline", "targeted"),
    "COMPRESSORS": ("identity", "topk", "int8", "lowrank"),
}
PORT_REGISTRIES = dict(AGGREGATORS=AGGREGATORS, ATTACKS=ATTACKS,
                       SELECTORS=SELECTORS, COALITIONS=COALITIONS,
                       FAULTS=FAULTS, COMPRESSORS=COMPRESSORS)


def test_readme_registry_table_lists_these_names():
    """The table's names are the ones the next test resolves, in both
    packages."""
    rows = {}
    for line in open(os.path.join(ROOT, "README.md")):
        cells = [c.strip() for c in line.split("|")]
        if len(cells) > 3 and cells[1].strip("`") in README_NAMES:
            rows[cells[1].strip("`")] = set(
                n.strip("` ") for n in cells[2].replace("/", ",").split(","))
    assert set(rows) == set(README_NAMES)
    for reg, names in README_NAMES.items():
        assert rows[reg] == set(names), reg


@pytest.mark.parametrize("registry,name", [
    (reg, name) for reg, names in README_NAMES.items() for name in names])
def test_registry_name_resolves_in_both_packages(registry, name):
    import repro.strategies as jstrategies
    getattr(jstrategies, registry).get(name)
    PORT_REGISTRIES[registry].get(name)
    field = registry[:-1].lower()
    kw = {"num_users": 6, "num_testers": 2, "num_malicious": 1}
    if field == "selector" and name == "fixed":
        kw["selector_kwargs"] = {"indices": (0, 1)}
    if field == "coalition" and name != "none":
        kw["coalition_size"] = 2
    fed = FedConfig(**kw, **{field: name})
    assert getattr(fed, field) == name
    if field == "coalition":
        from repro.core.engine.program import resolve_coalition as jres
        from repro_torch.core.engine import resolve_coalition
        assert (type(resolve_coalition(fed)).__name__
                == type(jres(JFedConfig(**kw, **{field: name}))).__name__)
    elif field == "fault":
        from repro.core.engine.program import resolve_fault as jres
        from repro_torch.core.engine import resolve_fault
        assert (type(resolve_fault(fed)).__name__
                == type(jres(JFedConfig(**kw, **{field: name}))).__name__)
    elif field != "compressor":
        agg, atk, sel = resolve_strategies(fed)
        jagg_, jatk, jsel = j_resolve(JFedConfig(**kw, **{field: name}))
        assert type(agg).__name__ == type(jagg_).__name__
        assert type(atk).__name__ == type(jatk).__name__
        assert type(sel).__name__ == type(jsel).__name__


@pytest.mark.parametrize("kwargs,power", [({}, 1.0), ({"power": 2.0}, 2.0)])
def test_accuracy_based_power_is_not_the_score_power(kwargs, power):
    """The engine's defaults offer ``score_power``; ``accuracy_based``
    takes ``power``, so it keeps 1.0 unless its own kwargs set it."""
    fed = dict(aggregator="accuracy_based", aggregator_kwargs=kwargs,
               score_power=4.0)
    assert resolve_strategies(FedConfig(**fed))[0].power == power
    assert j_resolve(JFedConfig(**fed))[0].power == power


def test_accuracy_based_round_needs_the_server_split():
    model = build_model(get_config("fedtest-mlp-mnist").replace(
        mlp_hidden=(16,)))
    data = make_federated_image_dataset(MNIST_LIKE, 4, num_samples=600,
                                        global_test=50, seed=0, device="cpu")
    fed = FedConfig(num_users=4, num_testers=2, local_steps=1,
                    aggregator="accuracy_based", num_malicious=1)
    tc = TrainConfig(optimizer="sgd", lr=0.1, schedule="constant",
                     batch_size=8, grad_clip=0.0)
    trainer = FederatedTrainer(model, fed, tc, eval_batch=32, device="cpu")
    state, metrics = trainer.run_round(trainer.init(), data)
    w = metrics["weights"]
    np.testing.assert_allclose(float(w.sum()), 1.0, atol=1e-6)
    assert (w >= 0).all()
    draws = trainer.draw(state, data)
    bx, by = gather_client_batches(data.train, draws.batch_idx)
    with pytest.raises(ValueError, match="server_data"):
        trainer.program.run(
            trainer.backend, state.global_params, state.scores, bx=bx,
            by=by, tx=data.test.xs[:, :32], ty=data.test.ys[:, :32],
            draws=draws, round_idx=1, counts=data.train.counts)


# ------------------------------------------------------------ entry points
CLI = ["--device", "cpu", "--arch", "fedtest-mlp-mnist", "--dataset",
       "mnist_like", "--users", "4", "--testers", "2", "--malicious", "1",
       "--rounds", "2", "--samples", "600", "--local-steps", "2",
       "--batch", "8"]


@pytest.mark.parametrize("flags,config", [
    (["--smoke", "--arch", "fedtest-cnn-mnist"], {}),
    (["--score-power", "2.0", "--score-decay", "0.3"], {}),
    (["--attack", "sign_flip", "--attack-kwargs",
      '{"placement": "first"}'], {"attack": "sign_flip"}),
    (["--selector", "fixed", "--selector-kwargs", '{"indices": [0, 3]}'],
     {"selector": "fixed"}),
    (["--crosstest-impl", "reference"], {"crosstest_impl": "reference"}),
    (["--eval-resample-every", "2"], {"eval_resample_every": 2}),
    (["--aggregator", "accuracy_based", "--selector", "score_weighted"],
     {"aggregator": "accuracy_based", "selector": "score_weighted"}),
    (["--attack", "label_flip_proxy", "--selector", "round_robin"],
     {"attack": "label_flip_proxy", "selector": "round_robin"}),
    (["--attack", "adaptive_scale", "--selector", "coverage"],
     {"attack": "adaptive_scale", "selector": "coverage"}),
])
def test_cli_runs_each_new_flag_on_the_cpu(tmp_path, flags, config):
    from repro_torch.launch.train import build, main, parse_args
    args = parse_args(CLI + flags)
    trainer, _, cfg = build(args)
    fed = trainer.fed
    if "--smoke" in flags:
        assert cfg.name.endswith("-smoke") and cfg.dtype == "float32"
    if "--score-power" in flags:
        assert (fed.score_power, fed.score_decay) == (2.0, 0.3)
        assert trainer.aggregator.score_power == 2.0
    if "--attack-kwargs" in flags:
        assert trainer.attack.malicious_indices(4) == (0,)
    if "--selector-kwargs" in flags:
        assert trainer.selector.indices == (0, 3)
    main(CLI + flags + ["--out", str(tmp_path)])
    hist = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert hist["round"] == [1, 2]
    assert all(np.isfinite(hist["global_accuracy"]))
    for k, v in config.items():
        assert hist["config"][k] == v


def test_quickstart_twin_runs_on_the_cpu(capsys):
    from repro_torch.examples.quickstart import main
    rows = main(["--device", "cpu", "--rounds", "2"])
    out = capsys.readouterr().out
    assert "fedtest-cnn-mnist (12,122 params), 6 users, 1 malicious" in out
    assert [r[0] for r in rows] == [1, 2]
    for _, acc, mal_w, w in rows:
        assert np.isfinite(acc) and len(w) == 6
        np.testing.assert_allclose(sum(w), 1.0, atol=1e-5)
        assert mal_w == pytest.approx(w[5], abs=1e-6)
    # the paper's scheme pays the random-weights attacker next to nothing
    assert rows[-1][2] < 1 / 6


def test_quickstart_twin_takes_any_pair(capsys):
    from repro_torch.examples.quickstart import main
    rows = main(["accuracy_based", "adaptive_scale", "--device", "cpu",
                 "--rounds", "2"])
    assert "(adaptive_scale attack, accuracy_based aggregation)" in \
        capsys.readouterr().out
    assert len(rows) == 2 and all(np.isfinite(r[1]) for r in rows)


def test_fedtest_cifar_twin_runs_on_the_cpu():
    from repro_torch.examples.fedtest_cifar import main, rounds_to_reach
    curves = main(["--device", "cpu", "--rounds", "2",
                   "--dataset", "mnist_like"])
    assert list(curves) == ["fedtest", "fedavg", "accuracy_based"]
    for agg, hist in curves.items():
        assert hist["aggregator"] == agg and hist["round"] == [1, 2]
        assert all(np.isfinite(hist["global_accuracy"]))
        assert all(0.0 <= m <= 1.0 for m in hist["malicious_weight"])
    # FedAvg pays by sample count: 3 of 8 users hold about 3/8 of them
    assert curves["fedavg"]["malicious_weight"][-1] > 0.2
    assert rounds_to_reach({"round": [1, 2], "global_accuracy": [0.1, 0.7]},
                           0.6) == 2
    assert rounds_to_reach({"round": [1], "global_accuracy": [0.1]},
                           0.6) is None


def test_example_twins_raise_without_a_card(monkeypatch):
    from repro_torch.examples import fedtest_cifar, quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="is_available"):
        fedtest_cifar.run_curve("mnist_like", "fedtest", 1, 1)
