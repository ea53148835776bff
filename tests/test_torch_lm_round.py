"""The port's LM federated round against the reference, and on its own.

All on the CPU at the reduced size (``reduce_for_smoke``: 2 layers, f32,
a vocabulary of 97, sequences of 32 tokens):

* data: ``make_token_stream`` and ``make_lm_federated_dataset`` bitwise
  the reference's;
* the LM ``make_eval_fn``'s ``[K, N]`` matrix (the kernel ops under the
  batched cross-test's nested vmap; on the CPU their plain versions)
  against the reference's kernel-routed one (its ``attention_xla`` /
  ``_ssd_xla``), for the dense and ssm families, from converted params:
  the counts exact, except at a token whose top-two reference logits lie
  within 1e-4 (reported, at most one);
* one LM round of each family with the reference's draws replayed: the
  counts exact as above (the attacker's near-uniform column by its
  logits); weights, scores, the malicious weight, the loss and the new
  global params, the ssm family's f32 ``A_log``, ``D`` and ``dt_bias``
  among them, at rtol 1e-4, atol 1e-5 (f32 sums in other orders);
* training reaches neither kernel op, and a cross-test calls each once a
  layer, whatever K and N;
* the example twin pays its attacker less than its uniform share;
* ``--dataset lm`` through the train CLI's ``build``.

Torch runs on one thread here: these small ops lose far more to thread
hand-offs than they gain when the suite's other workers share the cores.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import reduce_for_smoke as jreduce  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.core.cross_testing import (  # noqa: E402
    cross_test_accuracies as j_cross_test, make_eval_fn as j_make_eval_fn)
from repro.core.engine import LocalBackend as JLocalBackend  # noqa: E402
from repro.core.engine import round_keys  # noqa: E402
from repro.data import make_token_stream as j_make_token_stream  # noqa: E402
from repro.launch.train import (  # noqa: E402
    make_lm_federated_dataset as j_make_lm_data)
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FederatedTrainer, RoundState, cross_test_batched, make_eval_fn)
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core.engine import RoundDraws, training_route_model  # noqa: E402
from repro_torch.data import make_token_stream  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    build, make_lm_federated_dataset, parse_args)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from test_torch_round import _Recorder, _client_noise  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
VOCAB, SEQ, PER_USER = 97, 32, 48
N, K, STEPS, BATCH, EVAL = 4, 2, 2, 8, 16
ARCHS = {"dense": "qwen2-0.5b", "ssm": "mamba2-2.7b"}
# every LM family's arch, for the helpers (the moe and hybrid rounds are
# held in tests/test_torch_moe_round.py)
FAMILY_ARCHS = {**ARCHS, "moe": "granite-moe-1b-a400m",
                "hybrid": "jamba-1.5-large-398b"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _cfgs(family):
    """Both packages' reduced configs (2 layers) in f32 at vocabulary 97."""
    arch = FAMILY_ARCHS[family]
    kw = dict(dtype="float32", vocab_size=VOCAB)
    return (jreduce(jget_config(arch)).replace(**kw),
            reduce_for_smoke(get_config(arch)).replace(**kw))


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,seqs,length,topics,seed", [
    (97, 64, 33, 4, 0), (151936, 40, 65, 8, 3), (50280, 17, 9, 2, 11)])
def test_token_stream_is_bitwise_the_reference(vocab, seqs, length, topics,
                                               seed):
    got = make_token_stream(vocab, seqs, length, num_topics=topics,
                            seed=seed)
    want = j_make_token_stream(vocab, seqs, length, num_topics=topics,
                               seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("vocab,users,kw", [
    (VOCAB, N, dict(seq_len=SEQ, seqs_per_user=PER_USER)),
    (512, 4, {}), (151936, 3, dict(seed=2))])
def test_lm_federated_dataset_is_bitwise_the_reference(vocab, users, kw):
    got = make_lm_federated_dataset(vocab, users, device="cpu", **kw)
    want = j_make_lm_data(vocab, users, **kw)
    for part in ("train", "test"):
        for name in ("xs", "ys", "counts"):
            g = getattr(getattr(got, part), name).numpy()
            w = np.asarray(getattr(getattr(want, part), name))
            assert g.dtype == w.dtype, (part, name)
            np.testing.assert_array_equal(g, w)
    for name in ("global_x", "global_y", "server_x", "server_y"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


# ------------------------------------------------------------- near ties
def _near_ties(jmodel, models, batches, margin=1e-4):
    """[len(batches), N] count of eval tokens (labels not -1) whose
    top-two reference logits lie closer than ``margin``: the only tokens
    whose argmax may flip between the two packages."""
    fwd = jax.jit(jmodel.forward_train)
    n = jax.tree_util.tree_leaves(models)[0].shape[0]
    out = np.zeros((len(batches), n), np.int64)
    for ci in range(n):
        p = jax.tree_util.tree_map(lambda leaf: leaf[ci], models)
        for ki, (x, y) in enumerate(batches):
            logits = np.sort(np.asarray(fwd(p, {"tokens": x})[0]), -1)
            close = (logits[..., -1] - logits[..., -2]) < margin
            out[ki, ci] = int((close & (np.asarray(y) != -1)).sum())
    return out


def _assert_counts(got_acc, want_acc, ties, tokens, tie_dense=(),
                   max_ties=1):
    """The [K, N] correct-token counts equal, but where a near tie may
    flip one; every tie found is printed. Outside the ``tie_dense``
    client columns at most ``max_ties`` tokens may be near ties."""
    want = np.rint(np.asarray(want_acc) * tokens).astype(np.int64)
    got = np.rint(np.asarray(got_acc) * tokens).astype(np.int64)
    assert want.shape == got.shape
    if ties.sum():
        print(f"near ties (top-two margin < 1e-4) by [tester, client]: "
              f"{ties.tolist()}; counts {got.tolist()} (port), "
              f"{want.tolist()} (reference)")
    others = [c for c in range(ties.shape[1]) if c not in tie_dense]
    assert ties[:, others].sum() <= max_ties, ties
    assert (np.abs(got - want) <= ties).all(), (got, want, ties)


# ------------------------------------------------------------- eval matrix
@pytest.mark.parametrize("family", list(ARCHS))
def test_lm_eval_matrix_matches_reference(family):
    """Three models drawn by the reference, converted, cross-tested by two
    testers on 16 rows each (some labels -1): the port's kernel-routed
    matrix against the reference's."""
    _eval_matrix(family)


def _eval_matrix(family, max_ties=1):
    """The body of :func:`test_lm_eval_matrix_matches_reference`, each
    tester's counts held by :func:`_assert_counts` with ``max_ties``."""
    jcfg, tcfg = _cfgs(family)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    n = 3
    stacked = jax.vmap(jmodel.init)(jax.random.split(jax.random.PRNGKey(0),
                                                     n))
    rng = np.random.default_rng(5)
    tx = rng.integers(0, VOCAB, size=(K, EVAL, SEQ)).astype(np.int32)
    ty = rng.integers(-1, VOCAB, size=(K, EVAL, SEQ)).astype(np.int32)
    want = jax.jit(lambda s, x, y: j_cross_test(
        j_make_eval_fn(jmodel), s, x, y, impl="batched"))(
            stacked, jnp.asarray(tx), jnp.asarray(ty))
    tstacked = params_from_reference(
        jax.tree_util.tree_map(np.asarray, stacked), "cpu",
        model=_stacked_view(tmodel, n))
    got = cross_test_batched(make_eval_fn(tmodel), tstacked,
                             torch.from_numpy(tx), torch.from_numpy(ty))
    assert got.shape == (K, n) and got.dtype == torch.float32
    ties = _near_ties(jmodel, stacked,
                      [(jnp.asarray(tx[k]), ty[k]) for k in range(K)])
    for k in range(K):
        assert len({(ty[k] != -1).sum()}) == 1
    valid = (ty != -1).sum(axis=(1, 2))            # [K] tokens a tester
    for k in range(K):
        _assert_counts(got.numpy()[k:k + 1], np.asarray(want)[k:k + 1],
                       ties[k:k + 1], int(valid[k]), max_ties=max_ties)


def _stacked_view(model, n):
    """``model`` whose param shapes carry a leading [n] axis, for
    converting a stacked tree."""
    class View:
        def param_shapes(self):
            from repro_torch.utils import tree_map
            return tree_map(lambda s: (n,) + tuple(s), model.param_shapes())

        def param_dtypes(self):
            return model.param_dtypes()
    return View()


def test_routes_kernels_for_eval_and_twins_for_training():
    """The round trains through the twins and evaluates the caller's
    model, whose forward is the kernel ops'; both routes give the same
    logits (f32, at the file's tolerance), for each LM family, and a
    classifier is left as it is."""
    for family in ARCHS:
        _, tcfg = _cfgs(family)
        model = build_model(tcfg)
        assert not model.differentiable
        trained = training_route_model(model)
        assert trained.differentiable and trained.cfg == model.cfg
        trainer = FederatedTrainer(model,
                                   FedConfig(num_users=N, num_testers=K),
                                   TrainConfig(), eval_batch=EVAL,
                                   device="cpu")
        assert trainer.program.model is model
        assert trainer.program.train_model.differentiable
        params = model.init(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, VOCAB, size=(2, SEQ)))
        np.testing.assert_allclose(
            trained.forward_train(params, {"tokens": tokens}).numpy(),
            model.forward_train(params, {"tokens": tokens}).numpy(),
            rtol=RTOL, atol=ATOL)
    mlp = build_model(get_config("fedtest-mlp-mnist"))
    assert training_route_model(mlp) is mlp


# --------------------------------------------------------- replayed round
def _replay_lm(family):
    """One round of the example's config (4 users, 1 ``random_weights``
    attacker, 2 testers) in both packages from the reference's init, the
    port replaying the reference's draws; plain SGD, so the new params
    stay a smooth function of the gradients (AdamW's first step is
    ``lr * sign(g)`` where |g| is far below its eps, and a sign
    computed in another order may flip)."""
    jcfg, tcfg = _cfgs(family)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    kw = dict(seq_len=SEQ, seqs_per_user=PER_USER)
    jdata = j_make_lm_data(VOCAB, N, **kw)
    tdata = make_lm_federated_dataset(VOCAB, N, device="cpu", **kw)
    fed = dict(num_users=N, num_testers=K, num_malicious=1,
               local_steps=STEPS, attack="random_weights")
    tc = dict(optimizer="sgd", lr=0.5, schedule="constant",
              batch_size=BATCH, grad_clip=0.0)
    jtrainer = JTrainer(jmodel, JFedConfig(**fed),
                        JTrainConfig(remat=False, **tc), eval_batch=EVAL)
    ttrainer = FederatedTrainer(tmodel, FedConfig(**fed), TrainConfig(**tc),
                                eval_batch=EVAL, device="cpu")
    jstate = jax.jit(jtrainer.init)(jax.random.PRNGKey(0))
    rows = jnp.arange(N)[:, None, None]
    malicious = jtrainer.attack.malicious_indices(N)

    @jax.jit
    def jround(state):
        keys = round_keys(jax.random.fold_in(state.key, state.round_idx))
        tester_ids, part_mask = jtrainer.program.select_round(
            keys, state.round_idx, scores=state.scores.scores)
        u = jax.random.uniform(keys.batch, (N, STEPS, BATCH))
        batch_idx = (u * jdata.train.counts[:, None, None]
                     ).astype(jnp.int32)
        tx, ty = jdata.test.xs[:, :EVAL], jdata.test.ys[:, :EVAL]
        rec = _Recorder(JLocalBackend(N))
        out = jtrainer.program.run(
            rec, state.global_params, state.scores,
            bx=jdata.train.xs[rows, batch_idx],
            by=jdata.train.ys[rows, batch_idx], tx=tx, ty=ty,
            tester_ids=tester_ids, part_mask=part_mask, keys=keys,
            round_idx=state.round_idx, counts=jdata.train.counts)
        leaves = jax.tree_util.tree_leaves(state.global_params)
        noise = {c: _client_noise(keys.attack, c, leaves) for c in malicious}
        return out, rec.acc, rec.models, tester_ids, batch_idx, noise

    ((jglobal, jscores, _, jmetrics), jacc, jmodels, tester_ids, batch_idx,
     noise) = jround(jstate)
    draws = RoundDraws(
        batch_idx=_t(batch_idx).long(), tester_ids=_t(tester_ids),
        part_mask=torch.ones(N),
        noise={c: [_t(z) for z in zs] for c, zs in noise.items()})
    tstate = RoundState(
        global_params=params_from_reference(
            jax.tree_util.tree_map(np.asarray, jstate.global_params), "cpu",
            model=tmodel),
        scores=scoring.init_scores(N, "cpu"), round_idx=0,
        gen=torch.Generator())
    ttrainer.backend = _Recorder(ttrainer.backend)
    tnew, tmetrics = ttrainer.run_round(tstate, tdata, draws=draws)
    ids = np.asarray(tester_ids)
    ties = _near_ties(jmodel, jmodels,
                      [(jdata.test.xs[t, :EVAL], jdata.test.ys[t, :EVAL])
                       for t in ids])
    # the attackers' logits on each tester's rows, in both packages
    jfwd = jax.jit(jmodel.forward_train)
    logits = {}
    for c in malicious:
        jp = jax.tree_util.tree_map(lambda leaf: leaf[c], jmodels)
        tp = tree_map(lambda leaf: leaf[c], ttrainer.backend.models)
        for t in ids:
            x = jdata.test.xs[t, :EVAL]
            logits[c, t] = (
                tmodel.forward_train(tp, {"tokens": _t(x)}),
                np.asarray(jfwd(jp, {"tokens": x})[0]))
    return dict(jacc=jacc, tacc=ttrainer.backend.acc, ties=ties,
                jglobal=jglobal, jscores=jscores, jmetrics=jmetrics,
                tnew=tnew, tmetrics=tmetrics, ids=ids,
                malicious=list(malicious), logits=logits)


@pytest.fixture(scope="module")
def replayed_lm():
    """The dense family's round."""
    return _replay_lm("dense")


@pytest.fixture(scope="module")
def replayed_ssm():
    """The ssm family's round: ``ssd_chunked`` under vmap of grad, then
    the aggregation of its f32 ``A_log``, ``D`` and ``dt_bias``."""
    return _replay_lm("ssm")


def _check_counts(r):
    assert len(set(r["ids"].tolist())) == K
    # the attacker's column: random_weights draws each leaf at that leaf's
    # std, and a unit RMSNorm scale has std 0, so its norm scales are
    # ~1e-6 draws and its logits all lie within ~1e-5 of each other; its
    # argmax is a near tie at every token, so its logits are held instead,
    # each against the reference's at rtol 1e-4 of their spread
    _assert_counts(r["tacc"].numpy(), r["jacc"], r["ties"], EVAL * SEQ,
                   tie_dense=r["malicious"])
    assert r["logits"]
    for got, want in r["logits"].values():
        spread = float(want.max() - want.min())
        assert spread > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * spread)


def _check_weights_scores_and_global(r):
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
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    return got


def test_one_lm_round_accuracy_counts_match_exactly(replayed_lm):
    _check_counts(replayed_lm)


def test_one_lm_round_weights_scores_and_global_match(replayed_lm):
    _check_weights_scores_and_global(replayed_lm)


def test_one_ssm_round_accuracy_counts_match_exactly(replayed_ssm):
    _check_counts(replayed_ssm)


def test_one_ssm_round_weights_scores_and_global_match(replayed_ssm):
    """As the dense round, with the mamba block's f32 leaves: their new
    values are among the global params held above, and stay f32."""
    _check_weights_scores_and_global(replayed_ssm)
    mamba = replayed_ssm["tnew"].global_params["layers"]["slot_0"]["mamba"]
    for name in ("A_log", "D", "dt_bias"):
        assert mamba[name].dtype == torch.float32, name


# ------------------------------------------------------ the port on its own
@pytest.mark.parametrize("family", list(ARCHS))
def test_training_skips_the_kernel_ops_and_a_cross_test_folds(family,
                                                               monkeypatch):
    """The ops' plain routes, counted: local training calls neither (it
    differentiates the twins), a cross-test of K=2 testers over N=4
    models calls the op once a layer (the vmap rule folds K x N x rows
    into one batch), and the global eval once a layer."""
    _, tcfg = _cfgs(family)
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
    key = "flash" if family == "dense" else "ssd"
    assert seen["train"] == {"flash": 0, "ssd": 0}
    assert seen["cross_test"][key] == tcfg.num_layers
    assert set(calls[key]) == {(K * N * EVAL, SEQ) + calls[key][0][2:]}
    calls[key].clear()
    acc = trainer.global_accuracy(state, data)
    assert len(calls[key]) == tcfg.num_layers and 0.0 <= acc <= 1.0
    assert calls[key][0][0] == data.global_x.shape[0]
    w = metrics["weights"]
    assert abs(float(w.sum()) - 1.0) < 1e-6 and bool(torch.isfinite(w).all())


def test_example_twin_pays_the_attacker_less_than_its_share():
    """The reference's example at its settings (reduced qwen2, f32,
    vocabulary 97, 4 users, one ``random_weights`` attacker), three rounds:
    the attacker's weight stays below its uniform share of 1/4 (the
    reference's example pays it 0.0170 at round 3, 0.0140 at round 6, on
    the CPU)."""
    from repro_torch.examples.federated_llm import main
    trainer, state, hist, _ = main(["--device", "cpu", "--malicious", "1",
                                    "--rounds", "3"])
    assert hist["round"] == [1, 2, 3]
    assert all(np.isfinite(hist["global_accuracy"]))
    assert hist["malicious_weight"][-1] < 1 / 4
    assert tuple(trainer.attack.malicious_indices(4)) == (3,)


def test_cli_builds_the_lm_round(tmp_path):
    """``--dataset lm`` through the train CLI's ``build``, both families
    reduced on the CPU: the reference's data builder, the model's kernel
    routes, one round with finite weights."""
    for arch in ARCHS.values():
        trainer, data, cfg = build(parse_args(
            ["--device", "cpu", "--smoke", "--arch", arch, "--dataset", "lm",
             "--users", "4", "--testers", "2", "--malicious", "1",
             "--local-steps", "2", "--batch", "8", "--optimizer", "adamw",
             "--lr", "2e-3", "--rounds", "1", "--out", str(tmp_path)]))
        assert cfg.family in ("dense", "ssm")
        assert tuple(data.train.xs.shape) == (4, 64, 64)
        # 2 x 4 x 64 sequences drawn: the 256 after the clients' are the
        # global set (the server set, after them, is empty)
        assert tuple(data.global_x.shape) == (256, 64)
        assert not trainer.program.model.differentiable
        assert trainer.program.train_model.differentiable
        state, metrics = trainer.run_round(trainer.init(), data)
        assert abs(float(metrics["weights"].sum()) - 1.0) < 1e-6
    # the reduced depth the card's Mamba2 phase builds
    trainer, _, cfg = build(parse_args(
        ["--device", "cpu", "--arch", "mamba2-2.7b", "--dataset", "lm",
         "--users", "2", "--testers", "1"]), num_layers=1)
    assert cfg.num_layers == 1 and cfg.d_model == 2560


@pytest.mark.parametrize("argv,match", [
    (["--arch", "fedtest-cnn", "--dataset", "lm"], "do not go together"),
    (["--smoke", "--arch", "qwen2-0.5b", "--dataset", "cifar_like"],
     "do not go together"),
])
def test_cli_refuses_an_lm_mismatch(argv, match):
    with pytest.raises(SystemExit, match=match):
        build(parse_args(["--device", "cpu"] + argv))
