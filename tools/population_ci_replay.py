"""The reference CI's ``population-smoke`` job replayed round by round in
both packages on the CPU: one set of shards (the reference's
``SyntheticPopulation``, which the port reads through
:class:`ReferenceShards`), one init (the reference's, converted), and
every round's draws the reference's (its cohort, testers and batch
indices, as ``repro.core.engine.population.PopulationTrainer`` draws
them). Two port runs go beside the reference's run:

* ``free``: the port's own state, round after round, on those draws:
  the two malicious-weight series the CI's gate reads;
* ``synced``: each round played by the port from the reference's state
  of that round, so a round's difference is that round's alone.

A round "parts" when its ``[K, N]`` accuracy counts differ, or its
weights, scores or params leave rtol 1e-4, atol 1e-5 (the port's parity
tolerance); the step named is the first of those that does. One JSON
line a round, then a summary line. Imports both packages, so it runs
where the reference does, on the CPU (~1 min for the 12 rounds)::

  PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/population_ci_replay.py \\
      --seed 0
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.engine import round_keys  # noqa: E402
from repro.core.engine.population import (  # noqa: E402
    PopulationTrainer as JPopulationTrainer,
    cohort_from_mask as j_cohort_from_mask)
from repro.data import MNIST_LIKE as J_MNIST  # noqa: E402
from repro.data.population import (  # noqa: E402
    make_synthetic_population as j_make_population)
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    CohortPlan, RoundDraws, RoundState)
from repro_torch.core.scoring import ScoreState  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
EVAL_BATCH = 64


def _t(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype)


class ReferenceShards:
    """The port's population-data interface (``cohort_train``,
    ``tester_batches``, ``server_batch``, ``train_counts``) over the
    reference's ``SyntheticPopulation``: the port trains and tests on the
    reference's shards."""

    def __init__(self, jdata):
        self.jdata = jdata
        self.train_counts = _t(jdata.train_counts)

    def cohort_train(self, idx):
        x, y = self.jdata.cohort_train(jnp.asarray(idx.numpy()))
        return _t(x), _t(y, torch.int64)

    def tester_batches(self, tester_ids, eval_batch: int):
        x, y = self.jdata.tester_batches(jnp.asarray(tester_ids.numpy()),
                                         eval_batch)
        return _t(x), _t(y, torch.int64)

    def server_batch(self, eval_batch: int):
        x, y = self.jdata.server_batch(eval_batch)
        return _t(x), _t(y, torch.int64)


class _Recorder:
    """Keeps the ``[K, N]`` accuracy matrix a backend's cross-test gives."""

    def __init__(self, backend):
        self.backend, self.acc = backend, None

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def cross_test(self, *args):
        out = self.backend.cross_test(*args)
        # the reference's population backend returns (matrix, extras)
        self.acc = out[0] if isinstance(out, tuple) else out
        return out


def build(seed: int):
    """(reference trainer, its data, its state at round 0, port trainer,
    the shards the port reads), the job's settings as ``ci_population``
    gives them to both packages."""
    n, c = cs.CI_POPULATION, cs.CI_COHORT
    jfed = JFedConfig(num_users=n, cohort=c, participation=c / n,
                      num_testers=cs.CI_TESTERS,
                      num_malicious=cs.CI_MALICIOUS, attack="sign_flip",
                      aggregator="fedtest", selector="rotating",
                      local_steps=cs.CI_STEPS, rounds=cs.CI_ROUNDS,
                      seed=seed)
    jcfg = jget_config("fedtest-cnn-mnist").replace(
        cnn_channels=(8, 16, 16), cnn_hidden=32)
    jtc = JTrainConfig(optimizer="sgd", lr=cs.CI_LR, schedule="constant",
                       batch_size=cs.CI_BATCH, grad_clip=0.0, remat=False)
    jdata = j_make_population(
        n, per_client=max(cs.CI_BATCH * 4, 64),
        image_size=J_MNIST.image_size, channels=J_MNIST.channels,
        num_classes=J_MNIST.num_classes, noise=J_MNIST.noise, seed=seed)
    jtrainer = JPopulationTrainer(jbuild_model(jcfg), jfed, jtc,
                                  eval_batch=EVAL_BATCH,
                                  testers_from_cohort=True)
    jstate = jtrainer.init(jax.random.PRNGKey(seed))
    ttrainer, _ = cs.ci_population("cpu", seed)
    return jtrainer, jdata, jstate, ttrainer, ReferenceShards(jdata)


def reference_round(jtrainer, jdata):
    """The reference's population round, body for body its
    ``_round_body``, returning its draws and ``[K, N]`` matrix too."""
    fed, rec = jtrainer.fed, _Recorder(jtrainer.backend)
    n, capacity = fed.num_users, jtrainer.capacity

    @jax.jit
    def play(state):
        keys = round_keys(jax.random.fold_in(state.key, state.round_idx))
        tester_ids, part_mask = jtrainer.program.select_round(
            keys, state.round_idx, scores=state.scores.scores)
        idx, valid, eff = j_cohort_from_mask(part_mask, capacity)
        count = jnp.maximum(jnp.sum(valid).astype(jnp.int32), 1)
        tester_ids = jnp.minimum(idx[tester_ids % count], n - 1)
        safe = jnp.minimum(idx, n - 1)
        u = jax.random.uniform(keys.batch, (n, fed.local_steps,
                                            jtrainer.train.batch_size))
        bidx = (u * jdata.train_counts[:, None, None]).astype(
            jnp.int32)[safe]
        cx, cy = jdata.cohort_train(safe)
        bx = jax.vmap(lambda x, i: x[i])(cx, bidx)
        by = jax.vmap(lambda y, i: y[i])(cy, bidx)
        tx, ty = jdata.tester_batches(tester_ids, EVAL_BATCH)
        out = jtrainer.program.run(
            rec, state.global_params, state.scores, bx=(idx, valid, bx),
            by=by, tx=tx, ty=ty, tester_ids=tester_ids, part_mask=eff,
            keys=keys, round_idx=state.round_idx,
            counts=jdata.train_counts,
            server_data=jdata.server_batch(EVAL_BATCH),
            comp_state=state.comp_state)
        new_global, new_scores, new_comp, metrics = out
        new_state = state._replace(global_params=new_global,
                                   scores=new_scores,
                                   round_idx=state.round_idx + 1,
                                   comp_state=new_comp)
        return new_state, metrics, rec.acc, (tester_ids, eff, idx, valid,
                                             bidx)
    return play


def port_state(jstate, ttrainer, round_idx: int) -> RoundState:
    """A reference state as the port's (its generator unused: every draw
    is replayed)."""
    return RoundState(
        global_params=params_from_reference(
            jax.tree_util.tree_map(np.asarray, jstate.global_params),
            "cpu", model=ttrainer.model),
        scores=ScoreState(*(_t(a) for a in jstate.scores)),
        round_idx=round_idx, gen=torch.Generator())


def port_draws(draws, n: int) -> RoundDraws:
    tester_ids, eff, idx, valid, bidx = draws
    plan = CohortPlan(_t(idx).long(), _t(valid).float())
    assert all(i < n for i in plan.ids)
    return RoundDraws(batch_idx=_t(bidx).long(), tester_ids=_t(tester_ids),
                      part_mask=_t(eff), noise=None, cohort=plan)


def compare(tstate, tmetrics, tacc, jstate, jmetrics, jacc):
    """The first step at which a port round leaves the reference's, in
    the round's order (None where it does not), and the largest
    differences."""
    def off(got, want):
        got, want = got.detach().numpy(), np.asarray(want)
        return not np.allclose(got, want, rtol=RTOL, atol=ATOL)

    counts = (tacc * EVAL_BATCH).round().numpy()
    want_counts = np.round(np.asarray(jacc) * EVAL_BATCH)
    params = list(zip(tree_leaves(tstate.global_params),
                      jax.tree_util.tree_leaves(jstate.global_params)))
    steps = [("cross_test_counts", not np.array_equal(counts, want_counts)),
             ("scores", any(off(getattr(tstate.scores, f),
                                getattr(jstate.scores, f))
                            for f in tstate.scores._fields)),
             ("weights", off(tmetrics["weights"], jmetrics["weights"])),
             ("params", any(off(a, b) for a, b in params))]
    parted = next((name for name, bad in steps if bad), None)
    return parted, {
        "counts_differing": int((counts != want_counts).sum()),
        "max_abs_weights": float(np.abs(tmetrics["weights"].numpy()
                                        - np.asarray(jmetrics["weights"])
                                        ).max()),
        "max_abs_params": max(float(np.abs(a.numpy() - np.asarray(b)).max())
                              for a, b in params)}


def replay(seed: int = 0, rounds: int = cs.CI_ROUNDS, emit=print):
    """Play ``rounds`` rounds of the job in both packages on the
    reference's draws; returns the summary (also emitted)."""
    jtrainer, jdata, jstate, ttrainer, shards = build(seed)
    n = jtrainer.fed.num_users
    play = reference_round(jtrainer, jdata)
    ttrainer.backend = _Recorder(ttrainer.backend)
    free = port_state(jstate, ttrainer, 0)
    series = {"repro": [], "free": [], "synced": []}
    first_parted = {"free": None, "synced": None}
    for r in range(rounds):
        jnext, jmetrics, jacc, jdraws = play(jstate)
        if r == 0:
            # the replayed body is the reference's own round, bitwise
            own, _ = jtrainer.run_round(jstate, jdata)
            for a, b in zip(jax.tree_util.tree_leaves(own.global_params),
                            jax.tree_util.tree_leaves(jnext.global_params)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        draws = port_draws(jdraws, n)
        line = {"round": r + 1,
                "repro": float(jmetrics["malicious_weight"])}
        series["repro"].append(line["repro"])
        for run in ("free", "synced"):
            start = free if run == "free" else port_state(jstate, ttrainer,
                                                          r)
            got, tmetrics = ttrainer.run_round(start, shards, draws=draws)
            parted, diffs = compare(got, tmetrics, ttrainer.backend.acc,
                                    jnext, jmetrics, jacc)
            if parted and first_parted[run] is None:
                first_parted[run] = {"round": r + 1, "step": parted}
            w = float(tmetrics["malicious_weight"])
            series[run].append(w)
            line[run] = {"malicious_weight": w, "parted": parted, **diffs}
            if run == "free":
                free = got
        emit(json.dumps(line))
        jstate = jnext
    summary = {"seed": seed, "rounds": rounds, "series": series,
               "first_parted": first_parted,
               "max_abs_malicious_weight": max(
                   abs(a - b) for a, b in zip(series["repro"],
                                              series["free"])),
               "last_below_gate": {k: v[-1] < cs.CI_GATE
                                   for k, v in series.items()}}
    emit(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=cs.CI_ROUNDS)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    replay(args.seed, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
