"""The port's FedTest round against the reference, and on its own.

* data: the port's synthetic shards are bitwise the reference's;
* the round's pure functions (tester selection, scoring, attacks, the
  coordinate-wise combine above 64 clients) on identical inputs: ids
  exact, floats at 1e-6;
* one full round with the reference's random draws replayed through
  ``RoundDraws``: the [K, N] accuracy counts exact, weights, scores and
  the new global params at rtol=1e-4, atol=1e-5 (conv summation order);
  the same for the update-space paths (a coordinate-wise combine, Krum,
  a compressed exchange), entering with non-zero scores and error
  feedback, and the new error feedback too; for ``accuracy_based`` (the
  server's [N] eval counts exact too), ``adaptive_scale`` and a round
  with resampled eval rows;
* the port's own dynamics with ``torch.Generator`` draws;
* the port imports neither ``jax`` nor ``repro``, and never falls back
  to the CPU on its own.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.core import scoring as jscoring  # noqa: E402
from repro.core.attacks import (  # noqa: E402
    _random_weights as j_random_weights, _scaled_update as j_scaled_update,
    _sign_flip as j_sign_flip)
from repro.core.engine import LocalBackend as JLocalBackend  # noqa: E402
from repro.core.cross_testing import (  # noqa: E402
    eval_batch_indices as j_eval_batch_indices,
    sampled_eval_batches as j_sampled_eval_batches)
from repro.core.engine import round_keys  # noqa: E402
from repro.core.selection import select_testers as jselect  # noqa: E402
from repro.data import MNIST_LIKE as J_MNIST  # noqa: E402
from repro.data import make_federated_image_dataset as jmake_data  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    comp_state_from_reference, params_from_reference)
from repro_torch.core import (  # noqa: E402
    FederatedTrainer, RoundState, cross_test_batched, cross_test_reference,
    make_eval_fn)
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core.attacks import (  # noqa: E402
    _random_weights, _scaled_update, _sign_flip)
from repro_torch.core.engine import RoundDraws, flat_update_dim  # noqa: E402
from repro_torch.core.selection import pick_testers  # noqa: E402
from repro_torch.data import MNIST_LIKE, make_federated_image_dataset  # noqa: E402
from repro_torch.kernels.dequant_aggregate import dequant_aggregate  # noqa: E402
from repro_torch.kernels.robust_combine import robust_combine  # noqa: E402
from repro_torch.kernels.weighted_aggregate import weighted_aggregate  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(cnn_channels=(8, 16, 16), cnn_hidden=32)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# -------------------------------------------------------------------- data
def test_federated_dataset_is_bitwise_the_reference():
    kw = dict(num_samples=600, global_test=100, seed=3,
              partition_kwargs={"min_classes": 3})
    ref = jmake_data(J_MNIST, 5, **kw)
    got = make_federated_image_dataset(MNIST_LIKE, 5, device="cpu", **kw)
    pairs = [(got.train.xs, ref.train.xs), (got.train.ys, ref.train.ys),
             (got.train.counts, ref.train.counts),
             (got.test.xs, ref.test.xs), (got.test.ys, ref.test.ys),
             (got.test.counts, ref.test.counts),
             (got.global_x, ref.global_x), (got.global_y, ref.global_y),
             (got.server_x, ref.server_x), (got.server_y, ref.server_y)]
    for t, j in pairs:
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("partition,kw", [
    ("paper", {"min_classes": 8, "max_classes": 10}),
    ("dirichlet", {"alpha": 0.3}),
    ("iid", {}),
])
def test_every_partition_is_bitwise_the_reference(partition, kw):
    args = dict(num_samples=400, global_test=50, seed=5,
                partition=partition, partition_kwargs=kw)
    ref = jmake_data(J_MNIST, 4, **args)
    got = make_federated_image_dataset(MNIST_LIKE, 4, device="cpu", **args)
    for t, j in ((got.train.xs, ref.train.xs), (got.train.ys, ref.train.ys),
                 (got.test.counts, ref.test.counts)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------- pure functions
@pytest.mark.parametrize("n,k,seed", [(6, 2, 0), (20, 5, 1), (64, 7, 2)])
def test_select_testers_matches_reference(n, k, seed):
    key = jax.random.PRNGKey(seed)
    for r in range(3):
        u = jax.random.uniform(jax.random.fold_in(key, r), (n,))
        want = np.asarray(jselect(key, n, k, r))
        got = pick_testers(_t(u), k).numpy()
        np.testing.assert_array_equal(got, want)


def _score_case(n, k, seed, rounds_seen):
    rng = np.random.default_rng(seed)
    acc = rng.uniform(size=(k, n)).astype(np.float32)
    ids = rng.choice(n, size=k, replace=False).astype(np.int32)
    scores = rng.uniform(size=(n,)).astype(np.float32)
    trust = rng.uniform(0.2, 1.0, size=(n,)).astype(np.float32)
    row_mask = (rng.uniform(size=(k,)) < 0.7).astype(np.float32)
    client_mask = (rng.uniform(size=(n,)) < 0.6).astype(np.float32)
    jstate = jscoring.ScoreState(jnp.asarray(scores),
                                 jnp.asarray(rounds_seen, jnp.int32),
                                 jnp.asarray(trust))
    tstate = scoring.ScoreState(_t(scores),
                                torch.tensor(rounds_seen, dtype=torch.int32),
                                _t(trust))
    return acc, ids, row_mask, client_mask, jstate, tstate


@pytest.mark.parametrize("rounds_seen", [0, 1, 3])
@pytest.mark.parametrize("variant", ["plain", "masked", "trust_clip"])
def test_update_scores_and_weights_match_reference(rounds_seen, variant):
    acc, ids, row_mask, client_mask, jstate, tstate = _score_case(
        8, 4, rounds_seen + len(variant), rounds_seen)
    kw = dict(power=4.0, decay=0.5, power_warmup_rounds=2)
    jkw, tkw = dict(kw), dict(kw)
    if variant in ("masked", "trust_clip"):
        jkw.update(row_mask=jnp.asarray(row_mask),
                   client_mask=jnp.asarray(client_mask))
        tkw.update(row_mask=_t(row_mask), client_mask=_t(client_mask))
    if variant == "trust_clip":
        for d in (jkw, tkw):
            d.update(use_trust=True, report_clip=0.2)
        jstate = jscoring.update_tester_trust(
            jstate, jnp.asarray(acc), jnp.asarray(ids), decay=0.3,
            row_mask=jnp.asarray(row_mask))
        tstate = scoring.update_tester_trust(
            tstate, _t(acc), _t(ids).long(), decay=0.3,
            row_mask=_t(row_mask))
        np.testing.assert_allclose(tstate.tester_trust.numpy(),
                                   np.asarray(jstate.tester_trust),
                                   rtol=1e-6, atol=1e-6)
    jnew = jscoring.update_scores(jstate, jnp.asarray(acc),
                                  jnp.asarray(ids), **jkw)
    tnew = scoring.update_scores(tstate, _t(acc), _t(ids).long(), **tkw)
    np.testing.assert_allclose(tnew.scores.numpy(), np.asarray(jnew.scores),
                               rtol=1e-6, atol=1e-6)
    assert int(tnew.rounds_seen) == int(jnew.rounds_seen)
    np.testing.assert_allclose(scoring.score_weights(tnew).numpy(),
                               np.asarray(jscoring.score_weights(jnew)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_consensus_median_matches_reference(k):
    """Even counts average the two middle reports, as jnp.median does."""
    rng = np.random.default_rng(k)
    acc = rng.uniform(size=(k, 5)).astype(np.float32)
    row_mask = np.ones((k,), np.float32)
    row_mask[0] = 0.0
    for mask in (None, row_mask):
        want = np.asarray(jscoring._consensus_median(
            jnp.asarray(acc), None if mask is None else jnp.asarray(mask)))
        got = scoring._consensus_median(
            _t(acc), None if mask is None else _t(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,part", [
    (5, None), (6, None),
    (6, [1, 0, 1, 1, 1, 0]),            # an even subset: two middles
    (6, [1, 1, 0, 1, 1, 1]),            # an odd subset
])
def test_update_space_aggregators_match_reference(n, part):
    """The weights-path aggregators over one ``[N, D]`` update matrix with
    a far outlier row: the trimmed mean's consensus (``jnp.median``, or
    ``jnp.nanmedian`` over the sampled subset) and the weights of Krum,
    the trimmed mean and Weiszfeld."""
    from repro.strategies import AGGREGATORS as JAGG
    from repro.strategies.base import RoundContext as JCtx
    from repro_torch.strategies import AGGREGATORS
    from repro_torch.strategies.base import RoundContext
    rng = np.random.default_rng(n)
    u = rng.standard_normal((n, 300)).astype(np.float32)
    u[1] = 40.0 * rng.standard_normal(300)
    counts = np.full((n,), 10, np.int32)
    jpart = None if part is None else jnp.asarray(part, jnp.float32)
    tpart = None if part is None else _t(part, torch.float32)
    if part is None:
        want = np.asarray(jnp.median(jnp.asarray(u), axis=0))
    else:
        want = np.asarray(jnp.nanmedian(
            jnp.where(jpart[:, None] > 0, jnp.asarray(u), jnp.nan), axis=0))
    got = scoring._consensus_median(_t(u), tpart).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jctx = JCtx(acc_matrix=None, tester_ids=None, scores=None,
                counts=jnp.asarray(counts), round_idx=jnp.asarray(0),
                key=None, updates=jnp.asarray(u), participation=jpart)
    tctx = RoundContext(acc_matrix=None, tester_ids=None, scores=None,
                        counts=_t(counts), round_idx=0, updates=_t(u),
                        participation=tpart)
    for name, kw in (("krum", {"num_byzantine": 1}),
                     ("trimmed_mean", {"trim_fraction": 0.2}),
                     ("trimmed_mean", {"trim_fraction": 0.5}),
                     ("median", {})):
        jw = np.asarray(JAGG.build(name, kw, {}).weights(jctx))
        tw = AGGREGATORS.build(name, kw, {}).weights(tctx).numpy()
        np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-7,
                                   err_msg=f"{name} {kw}")
        if part is not None:
            assert (tw[np.asarray(part) == 0] == 0).all()


@pytest.mark.parametrize("n", [70, 100])
@pytest.mark.parametrize("name,kw", [
    ("trimmed_mean_coord", {"trim_fraction": 0.2, "score_gate": 0.5}),
    ("median_coord", {}),
])
def test_coord_combine_above_64_clients_matches_reference(n, name, kw):
    """Step 7 of path B100 (``chip_smoke.py``): the coordinate-wise
    combine over an ``[N, D]`` update matrix above 64 clients, gated by
    the FedTest scores and intersected with a participation mask, in both
    packages on the same numpy inputs. On the CPU the port runs the plain
    network, the schedule its CUDA kernel's register tier walks."""
    from repro.strategies import AGGREGATORS as JAGG
    from repro.strategies.base import RoundContext as JCtx
    from repro_torch.strategies import AGGREGATORS
    from repro_torch.strategies.base import RoundContext
    rng = np.random.default_rng(n)
    u = rng.standard_normal((n, 257)).astype(np.float32)
    u[-15:] = 30.0 * rng.standard_normal((15, 257))   # 15 % attackers
    s = rng.uniform(0.2, 1.0, size=(n,)).astype(np.float32)
    trust = np.ones((n,), np.float32)
    part = (rng.uniform(size=n) > 0.1).astype(np.float32)
    counts = np.full((n,), 10, np.int32)
    jscores = jscoring.ScoreState(jnp.asarray(s), jnp.asarray(3, jnp.int32),
                                  jnp.asarray(trust))
    tscores = scoring.ScoreState(_t(s), torch.tensor(3, dtype=torch.int32),
                                 _t(trust))
    jctx = JCtx(acc_matrix=None, tester_ids=None, scores=jscores,
                counts=jnp.asarray(counts), round_idx=jnp.asarray(3),
                key=None, updates=jnp.asarray(u),
                participation=jnp.asarray(part))
    tctx = RoundContext(acc_matrix=None, tester_ids=None, scores=tscores,
                        counts=_t(counts), round_idx=3, updates=_t(u),
                        participation=_t(part))
    jagg, tagg = JAGG.build(name, kw, {}), AGGREGATORS.build(name, kw, {})
    mask = tagg.gate_mask(tctx)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jagg.gate_mask(jctx)))
    assert 0 < int(mask.sum()) < n
    before = robust_combine.launches
    got = tagg.combine(tctx, _t(u)).numpy()
    want = np.asarray(jagg.combine(jctx, jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert robust_combine.launches == before


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"conv0": {"b": rng.standard_normal(4).astype(np.float32),
                      "w": rng.standard_normal((3, 3, 2, 4))
                      .astype(np.float32)},
            "fc1": {"b": rng.standard_normal(5).astype(np.float32),
                    "w": (3.0 * rng.standard_normal((6, 5)))
                    .astype(np.float32)}}


def _ttree(tree):
    return {k: {n: _t(a) for n, a in v.items()} for k, v in tree.items()}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_random_weights_matches_reference_on_the_same_draws(scale):
    """Same normal draws in, same corrupted model out: pins the
    population std (ddof=0) of the per-leaf magnitude."""
    trained, ref = _tree(0), _tree(1)
    key = jax.random.PRNGKey(7)
    want = j_random_weights(key, _jtree(trained), _jtree(ref), scale)
    leaves = jax.tree_util.tree_leaves(_jtree(trained))
    ks = jax.random.split(key, len(leaves))
    noise = [_t(jax.random.normal(kk, leaf.shape, jnp.float32))
             for kk, leaf in zip(ks, leaves)]
    got = _random_weights(noise, _ttree(trained), _ttree(ref), scale)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["sign_flip", "scaled_update"])
def test_update_attacks_match_reference(name):
    jfn, tfn = {"sign_flip": (j_sign_flip, _sign_flip),
                "scaled_update": (j_scaled_update, _scaled_update)}[name]
    trained, ref = _tree(2), _tree(3)
    want = jfn(None, _jtree(trained), _jtree(ref), 4.0)
    got = tfn(None, _ttree(trained), _ttree(ref), 4.0)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_update_matrix_and_tree_add_vector_match_reference():
    """``_flatten_updates`` gives the reference's [N, D] layout, and
    ``tree_add_vector`` scatters a [D] row (or every row of [N, D]) back
    as the reference does."""
    from repro.core.engine.backends import _flatten_updates as j_flatten
    from repro.utils.pytree import tree_add_vector as j_add
    from repro_torch.core.engine.backends import _flatten_updates
    from repro_torch.utils import tree_add_vector
    g = _tree(4)
    stacked = {k: {n: np.stack([a + i for i in range(3)]) for n, a in v.items()}
               for k, v in _tree(5).items()}
    got = _flatten_updates(_ttree(stacked), _ttree(g))
    want = np.asarray(j_flatten(_jtree(stacked), _jtree(g)))
    assert got.shape == want.shape == (3, 4 + 72 + 5 + 30)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    rows = tree_add_vector(_ttree(g), got)
    for i in range(3):
        one = tree_add_vector(_ttree(g), got[i])
        ref = j_add(_jtree(g), jnp.asarray(want[i]))
        for b_, o, r in zip(tree_leaves(rows), tree_leaves(one),
                            jax.tree_util.tree_leaves(ref)):
            assert torch.equal(b_[i], o)
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="width"):
        tree_add_vector(_ttree(g), got[0, 1:])


# ---------------------------------------------------- one round, replayed
class _Recorder:
    """Wraps a backend's cross_test to keep the [K, N] accuracy matrix
    and the models it was measured on."""

    def __init__(self, backend):
        self.backend = backend
        self.acc = self.models = self.server_acc = None

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def cross_test(self, eval_fn, models, tx, ty, tester_ids):
        out = self.backend.cross_test(eval_fn, models, tx, ty, tester_ids)
        acc = out[0] if isinstance(out, tuple) else out
        self.acc, self.models = acc, models
        return out

    def server_eval(self, eval_fn, models, sx, sy):
        fn = self.backend.server_eval(eval_fn, models, sx, sy)

        def run():
            self.server_acc = fn()
            return self.server_acc
        return run


N, K, STEPS, BATCH, EVAL = 6, 2, 3, 16, 64
# samples clients 0, 2, 3 and 4 in the replayed round: an even subset,
# so its median averages the two middle values, and a trim of 0.5 keeps
# three of the four
PARTICIPATION = 0.81


def _client_noise(attack_key, c, leaves):
    """random_weights' draws for client c, as ``Attack.apply`` derives
    them: ``split(fold_in(keys.attack, c), n_leaves)``, one normal each."""
    ks = jax.random.split(jax.random.fold_in(attack_key, c), len(leaves))
    return [jax.random.normal(k, leaf.shape, jnp.float32)
            for k, leaf in zip(ks, leaves)]


# the reference's draws of a fault model, from its keys.fault stream, as
# the port's Fault.draw makes them (targeted draws nothing)
FAULT_DRAWS = {
    "dropout": lambda key, n: jax.random.uniform(key, (n,)),
    "straggler_deadline": lambda key, n: jax.random.exponential(key, (n,)),
    "targeted": lambda key, n: None,
}


def _replay(aggregator="fedtest", aggregator_kwargs=(),
            compressor="identity", participation=1.0, entering_state=False,
            attack="random_weights", eval_resample_every=0, round_idx=0,
            fed_extra=None, convert=None):
    """One round of the quickstart-sized config in both packages, the
    port replaying the reference's draws. ``entering_state`` starts the
    round from non-zero scores (the malicious client's lowest) and, with
    a compressor, a non-zero error-feedback buffer, both made with numpy
    and handed to both packages. ``round_idx`` is the round played; with
    ``eval_resample_every`` the testers' eval rows are the reference's
    schedule-keyed draw for that round, replayed through
    ``RoundDraws.eval_idx``. ``fed_extra`` adds FedConfig fields to both
    (a fault's, the liars' and a coalition's draws are replayed too).
    ``convert(jtrainer, ttrainer, jstate, jdata)`` replaces the entering
    state:
    it returns the reference's and the port's (for a checkpoint
    converted from the reference)."""
    kw = dict(num_samples=3000, global_test=400, seed=0)
    jdata = jmake_data(J_MNIST, N, **kw)
    tdata = make_federated_image_dataset(MNIST_LIKE, N, device="cpu", **kw)
    jmodel = jbuild_model(jget_config("fedtest-cnn-mnist").replace(**SMALL))
    tmodel = build_model(get_config("fedtest-cnn-mnist").replace(**SMALL))
    fed = dict(num_users=N, num_testers=K, num_malicious=1,
               local_steps=STEPS, attack=attack,
               aggregator=aggregator, aggregator_kwargs=aggregator_kwargs,
               compressor=compressor, participation=participation,
               **(fed_extra or {}))
    tc = dict(optimizer="sgd", lr=0.1, schedule="constant",
              batch_size=BATCH, grad_clip=0.0)
    jtrainer = JTrainer(jmodel, JFedConfig(**fed),
                        JTrainConfig(remat=False, **tc), eval_batch=EVAL,
                        eval_resample_every=eval_resample_every)
    ttrainer = FederatedTrainer(tmodel, FedConfig(**fed), TrainConfig(**tc),
                                eval_batch=EVAL, device="cpu",
                                eval_resample_every=eval_resample_every)

    jstate = jax.jit(jtrainer.init)(jax.random.PRNGKey(0))
    jstate = jstate._replace(round_idx=jnp.asarray(round_idx, jnp.int32))
    comp_state = None
    scores = scoring.init_scores(N, "cpu")
    if entering_state:
        rng = np.random.default_rng(11)
        s = rng.uniform(0.4, 0.9, size=(N,)).astype(np.float32)
        s[-1] = 0.05
        trust = np.ones((N,), np.float32)
        jstate = jstate._replace(scores=jscoring.ScoreState(
            jnp.asarray(s), jnp.asarray(3, jnp.int32), jnp.asarray(trust)))
        scores = scoring.ScoreState(_t(s), torch.tensor(3, dtype=torch.int32),
                                    _t(trust))
        if compressor != "identity":
            comp_state = (rng.standard_normal(
                (N, flat_update_dim(tmodel))) * 1e-3).astype(np.float32)

    # the reference's round 0 with its key schedule, plus the draws it
    # consumed, in one compiled program
    rows = jnp.arange(N)[:, None, None]
    malicious = jtrainer.attack.malicious_indices(N)

    @jax.jit
    def jround(state, comp):
        keys = round_keys(jax.random.fold_in(state.key, state.round_idx))
        tester_ids, part_mask = jtrainer.program.select_round(
            keys, state.round_idx, scores=state.scores.scores)
        u = jax.random.uniform(keys.batch, (N, STEPS, BATCH))
        batch_idx = (u * jdata.train.counts[:, None, None]
                     ).astype(jnp.int32)
        eval_idx = None
        if eval_resample_every:
            # the driver's eval rows, and the indices that name them
            tx, ty = j_sampled_eval_batches(
                state.key, jdata.test, EVAL, state.round_idx,
                eval_resample_every)
            eval_idx = j_eval_batch_indices(
                state.key, jdata.test.counts, EVAL,
                state.round_idx // eval_resample_every)
        else:
            tx, ty = jdata.test.xs[:, :EVAL], jdata.test.ys[:, :EVAL]
        rec = _Recorder(JLocalBackend(N))
        out = jtrainer.program.run(
            rec, state.global_params, state.scores,
            bx=jdata.train.xs[rows, batch_idx],
            by=jdata.train.ys[rows, batch_idx], tx=tx, ty=ty,
            tester_ids=tester_ids, part_mask=part_mask, keys=keys,
            round_idx=state.round_idx, counts=jdata.train.counts,
            server_data=(jdata.server_x[:EVAL], jdata.server_y[:EVAL]),
            comp_state=comp)
        leaves = jax.tree_util.tree_leaves(state.global_params)
        noise = {c: _client_noise(keys.attack, c, leaves) for c in malicious}
        fault_draws = (FAULT_DRAWS[fed["fault"]](keys.fault, N)
                       if fed.get("fault", "none") != "none" else None)
        lies = (jax.random.uniform(keys.lie, (K, N))
                if fed.get("lying_testers") else None)
        return (out, rec.acc, rec.models, rec.server_acc, tester_ids,
                part_mask, batch_idx, eval_idx, tx, noise,
                jselect(keys.test, N, K, state.round_idx), fault_draws, lies)

    tstate = None
    if convert is not None:
        jstate, tstate = convert(jtrainer, ttrainer, jstate, jdata)
    ((jglobal, jscores, jcomp, jmetrics), jacc, jmodels, jserver, tester_ids,
     part_mask, batch_idx, eval_idx, jtx, noise, selected, fault_draws,
     lies) = jround(
        jstate, None if comp_state is None else jnp.asarray(comp_state))
    if "selector" not in fed:
        # the selector's ids are select_testers' on the round's test key
        np.testing.assert_array_equal(np.asarray(tester_ids),
                                      np.asarray(selected))

    # the same draws and entering state, in the port's form
    noise = {c: [_t(z) for z in zs] for c, zs in noise.items()}
    draws = RoundDraws(batch_idx=_t(batch_idx).long(),
                       tester_ids=_t(tester_ids), part_mask=_t(part_mask),
                       noise=noise,
                       eval_idx=(None if eval_idx is None
                                 else _t(eval_idx).long()),
                       fault_draws=(None if fault_draws is None
                                    else _t(fault_draws)),
                       lies=None if lies is None else _t(lies))
    if tstate is None:
        tparams = params_from_reference(
            jax.tree_util.tree_map(np.asarray, jstate.global_params), "cpu",
            model=tmodel)
        tstate = RoundState(
            global_params=tparams, scores=scores, round_idx=round_idx,
            gen=torch.Generator(),
            comp_state=(None if comp_state is None
                        else comp_state_from_reference(
                            comp_state, "cpu", model=tmodel, num_users=N)))
    ttrainer.backend = _Recorder(ttrainer.backend)
    tnew, tmetrics = ttrainer.run_round(tstate, tdata, draws=draws)
    return dict(jmodel=jmodel, jacc=jacc, jmodels=jmodels, jdata=jdata,
                jserver=jserver, jtx=jtx, eval_idx=eval_idx,
                tester_ids=np.asarray(tester_ids), jglobal=jglobal,
                jscores=jscores, jcomp=jcomp, jmetrics=jmetrics,
                tbackend=ttrainer.backend, tnew=tnew, tmetrics=tmetrics,
                part_mask=np.asarray(part_mask),
                gated=("score_gate" in dict(aggregator_kwargs)))


@pytest.fixture(scope="module")
def replayed_round():
    """The paper's round (fedtest, uncompressed) from the reference's
    init."""
    return _replay()


# the update-space paths: a coordinate-wise combine (gated and not), the
# weights-path aggregators over the update matrix (Krum, the client-level
# trimmed mean, Weiszfeld), the trimmed mean under client sampling, and
# two compressed exchanges; the server-side baseline, the adaptive attack
# (its attacker enters below its weight threshold, so it sends its honest
# update) and FedTest at round 2 with its eval rows resampled every second
# round (bucket 1, not the fixed prefix)
CASES = {
    "trimmed_mean_coord": dict(aggregator="trimmed_mean_coord",
                               aggregator_kwargs={"score_gate": 0.5}),
    "median_coord": dict(aggregator="median_coord"),
    "krum": dict(aggregator="krum"),
    "trimmed_mean": dict(aggregator="trimmed_mean"),
    "trimmed_mean_sampled": dict(aggregator="trimmed_mean",
                                 aggregator_kwargs={"trim_fraction": 0.5},
                                 participation=PARTICIPATION),
    "median": dict(aggregator="median"),
    "fedtest_int8": dict(compressor="int8"),
    "fedtest_topk": dict(compressor="topk"),
    "accuracy_based": dict(aggregator="accuracy_based"),
    "adaptive_scale": dict(attack="adaptive_scale"),
    "fedtest_resampled": dict(eval_resample_every=2, round_idx=2),
}


@pytest.fixture(scope="module", params=list(CASES))
def replayed_case(request):
    return _replay(entering_state=True, **CASES[request.param])


def _near_ties(jmodel, models, batches, margin=1e-4):
    """[len(batches), N] count of eval samples whose top-two reference
    logits are closer than ``margin`` — the only samples whose argmax may
    flip."""
    out = np.zeros((len(batches), N), np.int64)
    fwd = jax.jit(jmodel.forward_train)
    for ci in range(N):
        p = jax.tree_util.tree_map(lambda leaf: leaf[ci], models)
        for ki, x in enumerate(batches):
            logits = np.sort(np.asarray(fwd(p, {"images": x})[0]), -1)
            out[ki, ci] = int((logits[:, -1] - logits[:, -2] < margin).sum())
    return out


def _assert_counts_match(r):
    want = np.rint(np.asarray(r["jacc"]) * EVAL).astype(np.int64)
    got = np.rint(r["tbackend"].acc.numpy() * EVAL).astype(np.int64)
    assert want.shape == got.shape == (K, N)
    ties = _near_ties(r["jmodel"], r["jmodels"],
                      [r["jtx"][t] for t in r["tester_ids"]])
    assert ties.sum() <= 1, ties
    assert (np.abs(got - want) <= ties).all(), (got, want, ties)
    if r["jserver"] is not None:
        # the server's eval of every model: [N] counts on its rows
        want = np.rint(np.asarray(r["jserver"]) * EVAL).astype(np.int64)
        got = np.rint(r["tbackend"].server_acc.numpy() * EVAL).astype(
            np.int64)
        assert want.shape == got.shape == (N,)
        ties = _near_ties(r["jmodel"], r["jmodels"],
                          [r["jdata"].server_x[:EVAL]])[0]
        assert ties.sum() <= 1, ties
        assert (np.abs(got - want) <= ties).all(), (got, want, ties)


def _assert_round_matches(r):
    np.testing.assert_allclose(r["tmetrics"]["weights"].numpy(),
                               np.asarray(r["jmetrics"]["weights"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r["tnew"].scores.scores.numpy(),
                               np.asarray(r["jscores"].scores),
                               rtol=RTOL, atol=ATOL)
    for name in ("malicious_weight", "local_loss", "acc_matrix_mean"):
        np.testing.assert_allclose(float(r["tmetrics"][name]),
                                   float(r["jmetrics"][name]),
                                   rtol=RTOL, atol=ATOL)
    got = tree_leaves(r["tnew"].global_params)
    want = jax.tree_util.tree_leaves(r["jglobal"])
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    if r["jcomp"] is None:
        assert r["tnew"].comp_state is None
    else:
        np.testing.assert_allclose(r["tnew"].comp_state.numpy(),
                                   np.asarray(r["jcomp"]), rtol=RTOL,
                                   atol=ATOL)


def test_one_round_accuracy_counts_match_exactly(replayed_round):
    _assert_counts_match(replayed_round)


def test_one_round_weights_scores_and_global_match(replayed_round):
    _assert_round_matches(replayed_round)


def test_update_space_round_accuracy_counts_match_exactly(replayed_case):
    _assert_counts_match(replayed_case)


def test_update_space_round_matches_reference(replayed_case):
    """Weights, scores, the new global params and the new error feedback
    at the file's tolerances; the round entered with non-zero scores, so
    the score gate engages."""
    _assert_round_matches(replayed_case)
    part = replayed_case["part_mask"]
    if part.min() == 0.0:
        # the sampled case: four of six clients, one of them trimmed
        np.testing.assert_array_equal(part, [1, 0, 1, 1, 1, 0])
        w = replayed_case["tmetrics"]["weights"].numpy()
        assert ((w > 0) <= (part > 0)).all() and (w > 0).sum() == 3
    if replayed_case["gated"]:
        # the malicious client entered with the lowest score: gated out
        assert float(replayed_case["tmetrics"]["malicious_weight"]) == 0.0
    if replayed_case["jserver"] is not None:
        assert replayed_case["tbackend"].server_acc.shape == (N,)
    if replayed_case["eval_idx"] is not None:
        # bucket 1's rows, not the fixed prefix
        idx = np.asarray(replayed_case["eval_idx"])
        assert idx.shape == (N, EVAL)
        assert (idx != np.arange(EVAL)[None]).any()


# ------------------------------------------------------ the port's dynamics
@pytest.fixture(scope="module")
def small_setup():
    """The ``tests/test_fed_round.py`` setup, in the port."""
    model = build_model(get_config("fedtest-cnn-mnist").replace(**SMALL))
    data = make_federated_image_dataset(MNIST_LIKE, 6, num_samples=1800,
                                        global_test=300, seed=0,
                                        device="cpu")
    tc = TrainConfig(optimizer="sgd", lr=0.1, schedule="constant",
                     batch_size=16, grad_clip=0.0)
    return model, data, tc


def test_fedtest_suppresses_malicious_weight(small_setup):
    model, _, tc = small_setup
    data = make_federated_image_dataset(
        MNIST_LIKE, 6, num_samples=1800, global_test=300, seed=0,
        partition_kwargs={"min_classes": 8, "max_classes": 10},
        device="cpu")
    fed = FedConfig(num_users=6, num_testers=3, num_malicious=2,
                    local_steps=10, attack="random_weights", score_power=4.0)
    trainer = FederatedTrainer(model, fed, tc, eval_batch=64, device="cpu")
    state = trainer.init(seed=1)
    for _ in range(6):
        state, metrics = trainer.run_round(state, data)
    np.testing.assert_allclose(float(metrics["weights"].sum()), 1.0,
                               atol=1e-5)
    # 2/6 clients are malicious; uniform would give them 1/3 total weight
    assert float(metrics["malicious_weight"]) < 0.05


def test_fedavg_cannot_suppress_malicious(small_setup):
    model, data, tc = small_setup
    fed = FedConfig(num_users=6, num_testers=2, num_malicious=2,
                    local_steps=2, attack="random_weights",
                    aggregator="fedavg")
    trainer = FederatedTrainer(model, fed, tc, eval_batch=64, device="cpu")
    state, metrics = trainer.run_round(trainer.init(seed=1), data)
    assert float(metrics["malicious_weight"]) > 0.1


def test_participation_zeroes_non_participants(small_setup):
    model, data, tc = small_setup
    fed = FedConfig(num_users=6, num_testers=2, local_steps=2,
                    participation=0.5, aggregator="uniform")
    trainer = FederatedTrainer(model, fed, tc, eval_batch=64, device="cpu")
    state = trainer.init(seed=0)
    masks, rates = [], []
    for _ in range(4):
        state, metrics = trainer.run_round(state, data)
        w = metrics["weights"].numpy()
        rate = float(metrics["participation_rate"])
        k = int(round(rate * 6))
        np.testing.assert_allclose(w.sum(), 1.0, atol=1e-5)
        assert 1 <= k <= 6 and (w > 0).sum() == k
        np.testing.assert_allclose(w[w > 0], 1.0 / k, atol=1e-5)
        masks.append(tuple(w > 0))
        rates.append(rate)
    assert len(set(masks)) > 1 and any(r < 1.0 for r in rates)


def test_cpu_round_never_launches_the_kernel(small_setup):
    model, data, tc = small_setup
    fed = FedConfig(num_users=6, num_testers=2, local_steps=1,
                    attack="sign_flip", num_malicious=1, attack_scale=2.0)
    trainer = FederatedTrainer(model, fed, tc, eval_batch=32, device="cpu")
    before = weighted_aggregate.launches
    state, metrics = trainer.run_round(trainer.init(), data)
    assert weighted_aggregate.launches == before
    assert all(torch.isfinite(t).all() for t in
               tree_leaves(state.global_params))


def test_batched_cross_test_is_bitwise_the_reference_loop(small_setup):
    model, data, _ = small_setup
    gen = torch.Generator().manual_seed(3)
    stacked = {k: {n: torch.stack([model.init(gen)[k][n] for _ in range(4)])
                   for n in ("w", "b")} for k in model.param_shapes()}
    eval_fn = make_eval_fn(model)
    tx, ty = data.test.xs[:3, :32], data.test.ys[:3, :32]
    batched = cross_test_batched(eval_fn, stacked, tx, ty)
    looped = cross_test_reference(eval_fn, stacked, tx, ty)
    assert batched.shape == (3, 4)
    assert torch.equal(batched, looped)


def test_cli_trains_the_mlp_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train`` end to end, small."""
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--arch", "fedtest-mlp-mnist", "--dataset",
          "mnist_like", "--users", "4", "--testers", "2", "--malicious", "1",
          "--rounds", "2", "--samples", "600", "--local-steps", "2",
          "--batch", "8", "--out", str(tmp_path)])
    out = list(tmp_path.glob("*.json"))
    assert len(out) == 1
    hist = json.loads(out[0].read_text())
    assert hist["round"] == [1, 2]
    assert hist["config"]["device"] == "cpu"
    assert all(np.isfinite(hist["global_accuracy"]))


@pytest.mark.parametrize("flags,op", [
    (["--aggregator", "trimmed_mean_coord", "--agg-kwargs",
      '{"trim_fraction": 0.2, "score_gate": 0.5}'], robust_combine),
    (["--compressor", "int8"], dequant_aggregate),
])
def test_cli_runs_an_update_space_path_on_the_cpu(tmp_path, flags, op):
    """Paths B and C of ``chip_smoke.py``, small, on the CPU: the plain
    versions run and no kernel is launched."""
    from repro_torch.launch.train import main
    before = (op.launches, weighted_aggregate.launches)
    main(["--device", "cpu", "--arch", "fedtest-mlp-mnist", "--dataset",
          "mnist_like", "--users", "4", "--testers", "2", "--malicious", "1",
          "--rounds", "2", "--samples", "600", "--local-steps", "2",
          "--batch", "8", "--out", str(tmp_path)] + flags)
    hist = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert hist["round"] == [1, 2]
    assert all(np.isfinite(hist["global_accuracy"]))
    assert (op.launches, weighted_aggregate.launches) == before


# ------------------------------------------------------- guards and config
def _port_fed_config(ref):
    """A reference FedConfig as the port's. A field the port lacks must
    sit at the reference's default: the port would ignore it."""
    fields = {f.name for f in dataclasses.fields(FedConfig)}
    default = dataclasses.asdict(JFedConfig())
    given = dataclasses.asdict(ref)
    unported = {k: v for k, v in given.items()
                if k not in fields and v != default[k]}
    if unported:
        raise ValueError(f"reference fields the port lacks: {unported}")
    return FedConfig(**{k: v for k, v in given.items() if k in fields})


def test_reference_fedconfig_maps_over_field_for_field():
    # the port's fields are the reference's, with its defaults
    ref_defaults = dataclasses.asdict(JFedConfig())
    port_defaults = dataclasses.asdict(FedConfig())
    assert port_defaults == {k: ref_defaults[k] for k in port_defaults}
    ref = JFedConfig(num_users=20, num_testers=5, num_malicious=3,
                     participation=0.5, attack="sign_flip",
                     aggregator="trimmed_mean_coord",
                     aggregator_kwargs={"score_gate": 0.5},
                     compressor="int8", compressor_kwargs={"chunk": 64},
                     server_test_fraction=0.2, crosstest_impl="reference")
    port = dataclasses.asdict(_port_fed_config(ref))
    assert port == {k: v for k, v in dataclasses.asdict(ref).items()
                    if k in port}
    assert port["compressor_kwargs"] == (("chunk", 64),)
    assert port["server_test_fraction"] == 0.2
    assert port["crosstest_impl"] == "reference"
    # the adversary surface and a cohort map over too
    ref = JFedConfig(coalition="mutual_boost", coalition_size=2,
                     coalition_kwargs={"boost_to": 0.9}, fault="dropout",
                     fault_rate=0.3, lying_testers=1)
    assert dataclasses.asdict(_port_fed_config(ref)) == \
        dataclasses.asdict(ref)
    ref = JFedConfig(cohort=3, participation=0.5)
    assert dataclasses.asdict(_port_fed_config(ref)) == \
        dataclasses.asdict(ref)


def test_comp_state_from_reference_checks_width_and_values():
    model = build_model(get_config("fedtest-cnn-mnist").replace(**SMALL))
    dim = flat_update_dim(model)
    buf = np.random.default_rng(0).standard_normal((3, dim)).astype(
        np.float32)
    got = comp_state_from_reference(buf, "cpu", model=model, num_users=3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), buf)
    with pytest.raises(ValueError, match="flat update width"):
        comp_state_from_reference(buf[:, 1:], "cpu", model=model,
                                  num_users=3)
    with pytest.raises(ValueError, match="flat update width"):
        comp_state_from_reference(buf, "cpu", model=model, num_users=4)
    buf[1, 2] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        comp_state_from_reference(buf, "cpu", model=model, num_users=3)


@pytest.mark.parametrize("kw", [dict(cohort=3, participation=0.5),
                                dict(cohort=1, participation=0.1),
                                dict(cohort=20)])
def test_reference_fedconfig_with_an_unported_field_is_refused(kw):
    """Every reference field is a port field, and every value maps over:
    the port's FedConfig equals the reference's for these cohort kwargs
    (the population tier's)."""
    ref = JFedConfig(**kw)
    assert dataclasses.asdict(_port_fed_config(ref)) == \
        dataclasses.asdict(ref)
    assert dataclasses.asdict(FedConfig(**kw)) == dataclasses.asdict(ref)


def test_default_device_raises_without_a_card(small_setup, monkeypatch):
    model, _, tc = small_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        FederatedTrainer(model, FedConfig(num_users=6, num_testers=2), tc)


def test_resolve_device_makes_cudnn_deterministic(monkeypatch):
    """A run from one seed must repeat bitwise on the card too: the device
    resolver turns cuDNN's nondeterministic algorithms and its algorithm
    benchmarking off, whatever they were before, as it turns TF32 off."""
    from repro_torch.core.engine import resolve_device
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("kw,match", [
    (dict(coalition="mutual_boost"), "needs members"),
    (dict(coalition_size=1), "name the coalition"),
    (dict(fault_rate=1.0), "fault_rate"),
    (dict(compressor="no_such_thing"), "unknown compressor"),
    (dict(cohort=7), "cohort=7 must be in"),
    (dict(coalition="sybil_split", coalition_size=6), "coalition_size < N"),
    (dict(attack="no_such_thing"), "unknown attack"),
    (dict(selector="no_such_thing"), "unknown selector"),
    (dict(aggregator="no_such_thing"), "unknown aggregator"),
    (dict(cohort=3), "cohort < num_users requires participation < 1.0"),
])
def test_fedconfig_refuses_what_is_not_ported(kw, match):
    with pytest.raises((ValueError, KeyError), match=match):
        JFedConfig(num_users=6, num_testers=2, **kw)
    with pytest.raises((ValueError, KeyError), match=match):
        FedConfig(num_users=6, num_testers=2, **kw)


def test_port_imports_neither_jax_nor_the_reference():
    """In a fresh interpreter, importing every port module leaves jax and
    repro out of sys.modules; no port file or chip_smoke.py names them."""
    pkg = os.path.join(ROOT, "src", "repro_torch")
    mods = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                files.append(path)
                rel = os.path.relpath(path, os.path.join(ROOT, "src"))
                mods.append(rel[:-3].replace(os.sep, ".")
                            .replace(".__init__", ""))
    assert {"repro_torch.launch.serve", "repro_torch.models.attention",
            "repro_torch.models.decoder",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.decode_attention.ops",
            "repro_torch.configs.qwen2_0p5b"} <= set(mods)
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, n)
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
