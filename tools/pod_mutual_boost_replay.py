"""The pod phase's ``mutual_boost`` run (``chip_smoke.py`` P1:
``scenario_for_pod("mutual_boost_vs_fedtest", 4)``, 8 rounds, 10 local
SGD steps of 32, ``fedtest-cnn`` at full width on 4 CIFAR-like shards of
the 4,000 samples, 256 eval rows a tester) replayed round by round in
both packages on the CPU: one set of shards (each package's dataset function
makes the same arrays), one init (the reference's, converted) and every
round's draws the reference's (its testers, batch indices and the
attacker's ``random_weights`` noise). Two port runs go beside the
reference's run:

* ``free``: the port's own state, round after round, on those draws:
  the two malicious-weight series;
* ``synced``: each round played by the port from the reference's state
  of that round, so a round's difference is that round's alone.

The port trains one client at a time, as a pod rank does
(``--vmapped`` trains the local backend's vmapped stack instead). A
round "parts" when its ``[K, N]`` accuracy counts differ, or its scores,
weights or params leave rtol 1e-4, atol 1e-5 (the port's parity
tolerance); the step named is the first of those that does. One JSON line
a round, then a summary line. Imports both packages, so it runs where the
reference does, on the CPU (a few minutes for the 8 rounds)::

  PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/pod_mutual_boost_replay.py
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro.configs import scenario_for_pod as jscenario_for_pod  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.core.engine import LocalBackend as JLocalBackend  # noqa: E402
from repro.core.engine import round_keys  # noqa: E402
from repro.data import CIFAR_LIKE as J_CIFAR  # noqa: E402
from repro.data import make_federated_image_dataset as jmake_data  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config, scenario_for_pod  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    FederatedTrainer, RoundDraws, RoundState)
from repro_torch.core.scoring import ScoreState  # noqa: E402
from repro_torch.data import CIFAR_LIKE, make_federated_image_dataset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _t(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype)


class _Recorder:
    """Keeps the ``[K, N]`` accuracy matrix a backend's cross-test gives."""

    def __init__(self, backend):
        self.backend, self.acc = backend, None

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def cross_test(self, *args):
        out = self.backend.cross_test(*args)
        self.acc = out[0] if isinstance(out, tuple) else out
        return out


def fed_kwargs(rounds: int) -> dict:
    """P1's mutual_boost FedConfig fields (the same in both packages)."""
    fed = dataclasses.replace(
        scenario_for_pod("mutual_boost_vs_fedtest", cs.POD_N),
        local_steps=cs.POD_FED["local_steps"], seed=0, rounds=rounds)
    kw = dataclasses.asdict(fed)
    assert kw == dataclasses.asdict(dataclasses.replace(
        jscenario_for_pod("mutual_boost_vs_fedtest", cs.POD_N),
        local_steps=cs.POD_FED["local_steps"], seed=0, rounds=rounds))
    return kw


def _normal_leaves(key, leaves):
    """random_weights' draws for one client from its key, as
    ``Attack.apply`` derives them: one normal a leaf."""
    keys = jax.random.split(key, len(leaves))
    return [jax.random.normal(keys[i], leaf.shape, jnp.float32)
            for i, leaf in enumerate(leaves)]


def build(rounds: int, vmapped: bool, seed: int = 0):
    """(reference trainer, its data, its state at round 0, port trainer,
    port data)."""
    kw = fed_kwargs(rounds)
    data_kw = dict(num_samples=cs.POD_SAMPLES, seed=0)
    jdata = jmake_data(J_CIFAR, cs.POD_N, **data_kw)
    tdata = make_federated_image_dataset(CIFAR_LIKE, cs.POD_N, device="cpu",
                                         **data_kw)
    for a, b in ((jdata.train.xs, tdata.train.xs),
                 (jdata.test.xs, tdata.test.xs)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jtrainer = JTrainer(jbuild_model(jget_config("fedtest-cnn")),
                        JFedConfig(**kw),
                        JTrainConfig(remat=False, **cs.POD_TRAIN),
                        eval_batch=cs.POD_EVAL)
    ttrainer = FederatedTrainer(build_model(get_config("fedtest-cnn")),
                                FedConfig(**kw), TrainConfig(**cs.POD_TRAIN),
                                eval_batch=cs.POD_EVAL, device="cpu")
    if not vmapped:
        def train(local_train, global_params, bx, by):
            out = [local_train(global_params, bx[c], by[c])
                   for c in range(bx.shape[0])]
            return (tree_map(lambda *leaves: torch.stack(leaves),
                             *[params for params, _ in out]),
                    torch.stack([loss for _, loss in out]))
        ttrainer.backend.train = train
    ttrainer.backend = _Recorder(ttrainer.backend)
    jstate = jtrainer.init(jax.random.PRNGKey(seed))
    return jtrainer, jdata, jstate, ttrainer, tdata


def reference_round(jtrainer, jdata):
    """The reference's round, body for body its trainer's, returning the
    draws it consumed and its ``[K, N]`` matrix too."""
    n = jtrainer.fed.num_users
    steps, batch = jtrainer.fed.local_steps, jtrainer.train.batch_size
    rows = jnp.arange(n)[:, None, None]
    malicious = [int(c) for c in jtrainer.attack.malicious_indices(n)]
    ev = cs.POD_EVAL

    @jax.jit
    def play(state):
        keys = round_keys(jax.random.fold_in(state.key, state.round_idx))
        tester_ids, part_mask = jtrainer.program.select_round(
            keys, state.round_idx, scores=state.scores.scores)
        u = jax.random.uniform(keys.batch, (n, steps, batch))
        batch_idx = (u * jdata.train.counts[:, None, None]).astype(jnp.int32)
        rec = _Recorder(JLocalBackend(n))
        new_global, new_scores, _, metrics = jtrainer.program.run(
            rec, state.global_params, state.scores,
            bx=jdata.train.xs[rows, batch_idx],
            by=jdata.train.ys[rows, batch_idx],
            tx=jdata.test.xs[:, :ev], ty=jdata.test.ys[:, :ev],
            tester_ids=tester_ids, part_mask=part_mask, keys=keys,
            round_idx=state.round_idx, counts=jdata.train.counts,
            server_data=(jdata.server_x[:ev], jdata.server_y[:ev]))
        leaves = jax.tree_util.tree_leaves(state.global_params)
        noise = {c: _normal_leaves(jax.random.fold_in(keys.attack, c),
                                   leaves) for c in malicious}
        new_state = state._replace(global_params=new_global,
                                   scores=new_scores,
                                   round_idx=state.round_idx + 1)
        return new_state, metrics, rec.acc, (batch_idx, tester_ids,
                                             part_mask, noise)
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


def port_draws(draws) -> RoundDraws:
    batch_idx, tester_ids, part_mask, noise = draws
    return RoundDraws(batch_idx=_t(batch_idx).long(),
                      tester_ids=_t(tester_ids), part_mask=_t(part_mask),
                      noise={c: [_t(z) for z in zs]
                             for c, zs in noise.items()})


def compare(tstate, tmetrics, tacc, jstate, jmetrics, jacc):
    """The first step at which a port round leaves the reference's, in
    the round's order (None where it does not), and the largest
    differences."""
    def off(got, want):
        got, want = got.detach().numpy(), np.asarray(want)
        return not np.allclose(got, want, rtol=RTOL, atol=ATOL)

    counts = (tacc * cs.POD_EVAL).round().numpy()
    want_counts = np.round(np.asarray(jacc) * cs.POD_EVAL)
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


def replay(rounds: int = cs.POD_MB_ROUNDS, vmapped: bool = False,
           emit=print):
    """Play ``rounds`` rounds in both packages on the reference's draws;
    returns the summary (also emitted)."""
    jtrainer, jdata, jstate, ttrainer, tdata = build(rounds, vmapped)
    play = reference_round(jtrainer, jdata)
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
        draws = port_draws(jdraws)
        line = {"round": r + 1,
                "repro": float(jmetrics["malicious_weight"])}
        series["repro"].append(line["repro"])
        for run in ("free", "synced"):
            start = free if run == "free" else port_state(jstate, ttrainer,
                                                          r)
            got, tmetrics = ttrainer.run_round(start, tdata, draws=draws)
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
    summary = {"rounds": rounds, "vmapped": vmapped, "series": series,
               "first_parted": first_parted,
               "max_abs_malicious_weight": max(
                   abs(a - b) for a, b in zip(series["repro"],
                                              series["free"]))}
    emit(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=cs.POD_MB_ROUNDS)
    ap.add_argument("--vmapped", action="store_true",
                    help="train the port's clients as one vmapped stack")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    replay(args.rounds, args.vmapped)
    return 0


if __name__ == "__main__":
    sys.exit(main())
