"""The LM round on the population tier (``--dataset lm --population``) and
the vlm's round on its text, against the reference and the port's own
dense engine, on the CPU at the reduced size (``reduce_for_smoke``: f32,
a vocabulary of 97, sequences of 32 tokens):

* one LM population round (qwen2, N = 8, a cohort of 4, testers from it,
  two sign-flippers) on the reference ``PopulationTrainer``'s replayed
  draws: the ``[K, N]`` correct-token counts exact, weights, scores and
  the new global params at rtol 1e-4, atol 1e-5;
* the LM population round against the port's dense LM engine over two
  rounds (``random_weights`` fed the population's keyed noise): every
  discrete field bitwise (testers, masks, the cohort, the counts, which
  weights are zero), the floats within rtol 1e-6, atol 1e-7;
* the vlm's round (pixtral, its text alone, AdamW) on the reference's
  replayed draws: the counts as above, the weights, scores and every
  global param, ``patch_proj`` included (no gradient reaches it; AdamW's
  weight decay still moves it), at rtol 1e-4, atol 1e-5;
* ``--dataset lm --population`` and the vlm's ``--dataset lm`` through
  the train CLI.

Torch runs on one thread here: these small ops lose far more to thread
hand-offs than they gain when the suite's other workers share the cores.
"""
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
from repro.core.engine import LocalBackend as JLocalBackend  # noqa: E402
from repro.core.engine import round_keys  # noqa: E402
from repro.core.engine.population import (  # noqa: E402
    PopulationTrainer as JPopulationTrainer,
    cohort_from_mask as j_cohort_from_mask)
from repro.data.population import (  # noqa: E402
    DensePopulationData as JDensePopulationData)
from repro.launch.train import (  # noqa: E402
    make_lm_federated_dataset as j_make_lm_data)
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import FederatedTrainer, RoundState  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    CohortPlan, PopulationTrainer, RoundDraws)
from repro_torch.core.engine.population import client_noise  # noqa: E402
from repro_torch.data import DensePopulationData  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    build, make_lm_federated_dataset, parse_args)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_lm_round import (  # noqa: E402
    _assert_counts, _near_ties, _t)
from test_torch_round import _Recorder, _client_noise  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
OWN = dict(rtol=1e-6, atol=1e-7)
VOCAB, SEQ, PER_USER, EVAL, BATCH, STEPS = 97, 32, 48, 16, 8, 2
SGD = dict(optimizer="sgd", lr=0.5, schedule="constant", batch_size=BATCH,
           grad_clip=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch):
    kw = dict(dtype="float32", vocab_size=VOCAB)
    return (jreduce(jget_config(arch)).replace(**kw),
            reduce_for_smoke(get_config(arch)).replace(**kw))


def _ref_params(jstate, tmodel):
    return params_from_reference(
        jax.tree_util.tree_map(np.asarray, jstate.global_params), "cpu",
        model=tmodel)


def _hold_floats(tnew, tmetrics, jglobal, jscores, jmetrics):
    pairs = [(tmetrics["weights"], jmetrics["weights"]),
             (tnew.scores.scores, jscores.scores),
             (tmetrics["malicious_weight"], jmetrics["malicious_weight"])]
    got = tree_leaves(tnew.global_params)
    want = jax.tree_util.tree_leaves(jglobal)
    assert len(got) == len(want)
    pairs += list(zip(got, want))
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


# ------------------------------------ (a) the LM population round, reference
def test_lm_population_round_matches_reference_on_its_draws():
    n, cap, k = 8, 4, 2
    jcfg, tcfg = _cfgs("qwen2-0.5b")
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    kw = dict(seq_len=SEQ, seqs_per_user=PER_USER)
    jpd = JDensePopulationData(j_make_lm_data(VOCAB, n, **kw))
    pd = DensePopulationData(make_lm_federated_dataset(VOCAB, n,
                                                       device="cpu", **kw))
    fed = dict(num_users=n, num_testers=k, num_malicious=2,
               local_steps=STEPS, participation=0.5, cohort=cap,
               attack="sign_flip")
    jtrainer = JPopulationTrainer(jmodel, JFedConfig(**fed),
                                  JTrainConfig(remat=False, **SGD),
                                  eval_batch=EVAL, testers_from_cohort=True)
    ttrainer = PopulationTrainer(tmodel, FedConfig(**fed), TrainConfig(**SGD),
                                 eval_batch=EVAL, device="cpu",
                                 testers_from_cohort=True)
    jstate = jtrainer.init(jax.random.PRNGKey(3))
    rec = _Recorder(jtrainer.backend)

    @jax.jit
    def jround(state):
        keys = round_keys(jax.random.fold_in(state.key, state.round_idx))
        tester_ids, part_mask = jtrainer.program.select_round(
            keys, state.round_idx, scores=state.scores.scores)
        idx, valid, eff = j_cohort_from_mask(part_mask, cap)
        count = jnp.maximum(jnp.sum(valid).astype(jnp.int32), 1)
        tester_ids = jnp.minimum(idx[tester_ids % count], n - 1)
        safe = jnp.minimum(idx, n - 1)
        u = jax.random.uniform(keys.batch, (n, STEPS, BATCH))
        bidx = (u * jpd.train_counts[:, None, None]).astype(jnp.int32)[safe]
        cx, cy = jpd.cohort_train(safe)
        bx = jax.vmap(lambda x, i: x[i])(cx, bidx)
        by = jax.vmap(lambda y, i: y[i])(cy, bidx)
        tx, ty = jpd.tester_batches(tester_ids, EVAL)
        out = jtrainer.program.run(
            rec, state.global_params, state.scores, bx=(idx, valid, bx),
            by=by, tx=tx, ty=ty, tester_ids=tester_ids, part_mask=eff,
            keys=keys, round_idx=state.round_idx,
            counts=jpd.train_counts, server_data=jpd.server_batch(EVAL),
            comp_state=state.comp_state)
        return out, rec.acc, tester_ids, eff, bidx, idx, valid

    ((jglobal, jscores, _, jmetrics), jacc, tester_ids, eff, bidx, idx,
     valid) = jround(jstate)
    # the replayed body is the reference's own round
    jnext, _ = jtrainer.run_round(jstate, jpd)
    for a, b in zip(jax.tree_util.tree_leaves(jnext.global_params),
                    jax.tree_util.tree_leaves(jglobal)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    draws = RoundDraws(batch_idx=_t(bidx).long(), tester_ids=_t(tester_ids),
                       part_mask=_t(eff),
                       cohort=CohortPlan(_t(idx).long(), _t(valid).float()))
    ids = draws.cohort.ids
    assert 0 < len(ids) <= cap and set(_t(tester_ids).tolist()) <= set(ids)
    ttrainer.backend = _Recorder(ttrainer.backend)
    tnew, tmetrics = ttrainer.run_round(
        RoundState(global_params=_ref_params(jstate, tmodel),
                   scores=scoring.init_scores(n, "cpu"), round_idx=0,
                   gen=torch.Generator()), pd, draws=draws)
    testers = np.asarray(jpd.dense.test.ys)[np.asarray(tester_ids), :EVAL]
    tokens = (testers != -1).sum(axis=(1, 2))[:, None]        # [K, 1]
    np.testing.assert_array_equal(
        np.rint(ttrainer.backend.acc.numpy() * tokens),
        np.rint(np.asarray(jacc) * tokens))
    _hold_floats(tnew, tmetrics, jglobal, jscores, jmetrics)


# ------------------------------ (b) the LM population round, dense engine
class _Acc:
    def __init__(self, backend):
        self.backend, self.acc = backend, None

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def cross_test(self, *args):
        self.acc = self.backend.cross_test(*args)
        return self.acc


@pytest.mark.parametrize("attack,rounds", [("sign_flip", 2),
                                           ("random_weights", 1)])
def test_lm_population_round_matches_the_dense_lm_engine(attack, rounds):
    """With a noise-free attack both engines draw one stream, round after
    round; ``random_weights``' dense engine draws its noise from the
    round's generator, so its round is held once, on the population's
    keyed noise."""
    n = 4
    _, tcfg = _cfgs("qwen2-0.5b")
    model = build_model(tcfg)
    data = make_lm_federated_dataset(VOCAB, n, seq_len=SEQ,
                                     seqs_per_user=PER_USER, device="cpu")
    pd = DensePopulationData(data)
    fed = FedConfig(num_users=n, num_testers=2, num_malicious=1,
                    local_steps=STEPS, participation=0.6, cohort=n,
                    attack=attack)
    dense = FederatedTrainer(model, fed, TrainConfig(**SGD), eval_batch=EVAL,
                             device="cpu")
    pop = PopulationTrainer(model, fed, TrainConfig(**SGD), eval_batch=EVAL,
                            device="cpu")
    dense.backend, pop.backend = _Acc(dense.backend), _Acc(pop.backend)
    sd, sp = dense.init(4), pop.init(4)
    tokens = int((data.test.ys[0, :EVAL] != -1).sum())
    for r in range(rounds):
        ddraws, pdraws = dense.draw(sd, data), pop.draw(sp, pd)
        ids = pdraws.cohort.ids
        assert ids == tuple(i for i in range(n) if ddraws.part_mask[i] > 0)
        if ddraws.noise is not None:
            # the population's keyed noise for its members, the dense
            # draw elsewhere
            leaves = tree_leaves(sd.global_params)
            assert set(ddraws.noise) & set(ids)
            ddraws = ddraws._replace(noise={
                c: client_noise(4, r, c, leaves) if c in ids else z
                for c, z in ddraws.noise.items()})
        else:
            assert torch.equal(sd.gen.get_state(), sp.gen.get_state())
        sd, md = dense.run_round(sd, data, draws=ddraws)
        sp, mp = pop.run_round(sp, pd, draws=pdraws)
        assert torch.equal(ddraws.tester_ids, pdraws.tester_ids)
        assert torch.equal(ddraws.part_mask, pdraws.part_mask)
        assert torch.equal((dense.backend.acc * tokens).round(),
                           (pop.backend.acc * tokens).round()), r
        assert torch.equal(md["weights"] == 0, mp["weights"] == 0)
        assert (mp["weights"][[i for i in range(n) if i not in ids]]
                == 0).all()
        pairs = list(zip(tree_leaves(sd.global_params),
                         tree_leaves(sp.global_params)))
        pairs += list(zip(sd.scores, sp.scores))
        pairs += [(md[k], mp[k]) for k in ("weights", "malicious_weight",
                                          "local_loss", "acc_matrix_mean")]
        for a, b in pairs:
            torch.testing.assert_close(b, a, **OWN)


# ------------------------------------------- (c) the vlm's round, reference
def test_vlm_text_round_matches_reference_under_adamw():
    """pixtral's round on its text: the reference's ``forward_train``
    reads ``batch.get("patches")``, None, so ``patch_proj`` has a zero
    gradient and moves only by AdamW's weight decay; the port's must
    match it."""
    n, k = 3, 2
    jcfg, tcfg = _cfgs("pixtral-12b")
    assert tcfg.family == "vlm"
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    kw = dict(seq_len=SEQ, seqs_per_user=PER_USER)
    jdata = j_make_lm_data(VOCAB, n, **kw)
    tdata = make_lm_federated_dataset(VOCAB, n, device="cpu", **kw)
    fed = dict(num_users=n, num_testers=k, num_malicious=1,
               local_steps=STEPS, attack="random_weights")
    # eps 1e-3: at the default 1e-8 AdamW's first step is lr * sign(g)
    # wherever |g| is far above eps, and a gradient within rounding of 0,
    # summed in another order, flips the sign of a 2 * lr move
    tc = dict(optimizer="adamw", lr=2e-3, eps=1e-3, schedule="constant",
              batch_size=BATCH, grad_clip=0.0)
    jtrainer = JTrainer(jmodel, JFedConfig(**fed),
                        JTrainConfig(remat=False, **tc), eval_batch=EVAL)
    ttrainer = FederatedTrainer(tmodel, FedConfig(**fed), TrainConfig(**tc),
                                eval_batch=EVAL, device="cpu")
    jstate = jax.jit(jtrainer.init)(jax.random.PRNGKey(0))
    rows = jnp.arange(n)[:, None, None]
    malicious = jtrainer.attack.malicious_indices(n)

    @jax.jit
    def jround(state):
        keys = round_keys(jax.random.fold_in(state.key, state.round_idx))
        tester_ids, part_mask = jtrainer.program.select_round(
            keys, state.round_idx, scores=state.scores.scores)
        u = jax.random.uniform(keys.batch, (n, STEPS, BATCH))
        bidx = (u * jdata.train.counts[:, None, None]).astype(jnp.int32)
        rec = _Recorder(JLocalBackend(n))
        out = jtrainer.program.run(
            rec, state.global_params, state.scores,
            bx=jdata.train.xs[rows, bidx], by=jdata.train.ys[rows, bidx],
            tx=jdata.test.xs[:, :EVAL], ty=jdata.test.ys[:, :EVAL],
            tester_ids=tester_ids, part_mask=part_mask, keys=keys,
            round_idx=state.round_idx, counts=jdata.train.counts)
        leaves = jax.tree_util.tree_leaves(state.global_params)
        noise = {c: _client_noise(keys.attack, c, leaves) for c in malicious}
        return out, rec.acc, rec.models, tester_ids, bidx, noise

    ((jglobal, jscores, _, jmetrics), jacc, jmodels, tester_ids, bidx,
     noise) = jround(jstate)
    draws = RoundDraws(
        batch_idx=_t(bidx).long(), tester_ids=_t(tester_ids),
        part_mask=torch.ones(n),
        noise={c: [_t(z) for z in zs] for c, zs in noise.items()})
    before = _ref_params(jstate, tmodel)
    ttrainer.backend = _Recorder(ttrainer.backend)
    tnew, tmetrics = ttrainer.run_round(
        RoundState(global_params=before, scores=scoring.init_scores(n, "cpu"),
                   round_idx=0, gen=torch.Generator()), tdata, draws=draws)
    ids = np.asarray(tester_ids)
    testers = [(jdata.test.xs[t, :EVAL], jdata.test.ys[t, :EVAL])
               for t in ids]
    ties = _near_ties(jmodel, jmodels, testers)
    _assert_counts(ttrainer.backend.acc.numpy(), jacc, ties, EVAL * SEQ,
                   tie_dense=list(malicious))
    _hold_floats(tnew, tmetrics, jglobal, jscores, jmetrics)
    # an honest client's patch_proj: decayed, not trained
    honest = [c for c in range(n) if c not in malicious][0]
    got = ttrainer.backend.models["patch_proj"][honest]
    want = np.asarray(jmodels["patch_proj"][honest])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not torch.equal(got, before["patch_proj"])
    assert float((got - before["patch_proj"]).abs().max()) < 1e-4


# ------------------------------------------------------------- the CLI
def test_cli_builds_the_lm_population_and_the_vlm_round(tmp_path):
    base = ["--device", "cpu", "--smoke", "--dataset", "lm", "--testers",
            "2", "--malicious", "1", "--local-steps", "1", "--batch", "4",
            "--out", str(tmp_path)]
    trainer, data, cfg = build(parse_args(
        base + ["--arch", "qwen2-0.5b", "--population", "8", "--cohort",
                "4", "--testers-from-cohort", "--rounds-per-call", "2"]))
    assert isinstance(trainer, PopulationTrainer)
    assert isinstance(data, DensePopulationData)
    assert trainer.rounds_per_call == 2 and trainer.capacity == 4
    assert trainer.program.train_model.differentiable
    state, stacked = trainer.run_chunk(trainer.init(), data)
    assert stacked["weights"].shape == (2, 8) and state.round_idx == 2
    trainer, data, cfg = build(parse_args(
        base + ["--arch", "pixtral-12b", "--users", "3"]))
    assert cfg.family == "vlm" and isinstance(trainer, FederatedTrainer)
    state, metrics = trainer.run_round(trainer.init(), data)
    assert abs(float(metrics["weights"].sum()) - 1.0) < 1e-6
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(state.global_params))

