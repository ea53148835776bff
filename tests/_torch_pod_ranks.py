"""What the pod tests' spawned ranks run (``repro_torch.launch.mesh.
run_ranks`` pickles a module-level function by its import path, so the
ranks' code lives here, free of JAX), the set-ups the tests' local runs
share with them, and the bitwise comparison of two runs.

Every case is the reference's pod matrix (``tests/test_pod_parity.py``):
``fedtest-cnn-mnist`` cut to channels (4, 8, 8) and a hidden width of
16, four clients on the reference's mildly skewed shards, SGD at 0.1 in
batches of 8. A run returns, round by round, every metric, the ``[K, N]``
accuracy matrix the backend handed the program, and at its end the
params, scores, error feedback and generator state, as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

N = 4
EVAL = 64
CNN = dict(cnn_channels=(4, 8, 8), cnn_hidden=16)
TRAIN = dict(optimizer="sgd", lr=0.1, schedule="constant", batch_size=8,
             grad_clip=0.0)
# the reference pod matrix's data and, for the resume cases, POD_SCRIPT's
MATRIX_DATA = dict(num_samples=1600, global_test=256, seed=0,
                   partition_kwargs={"min_classes": 8, "max_classes": 10})
RESUME_DATA = dict(num_samples=1200, global_test=128, seed=0)
RESUME_FED = dict(num_users=N, num_testers=N, num_malicious=1,
                  attack="sign_flip", attack_scale=4.0, local_steps=4,
                  fault="dropout", fault_rate=0.25, seed=0)
RESUME_ROUNDS, RESUME_SPLIT = 8, 4


def model_and_train():
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return (build_model(get_config("fedtest-cnn-mnist").replace(**CNN)),
            TrainConfig(**TRAIN))


def dataset(**kw):
    from repro_torch.data import MNIST_LIKE, make_federated_image_dataset
    return make_federated_image_dataset(MNIST_LIKE, N, device="cpu",
                                        **(kw or MATRIX_DATA))


def _np(t):
    return t.detach().cpu().numpy().copy()


def record_acc(backend):
    """The list that each later round's ``[K, N]`` accuracy matrix from
    ``backend`` is appended to (its ``cross_test`` wrapped in place)."""
    acc, inner = [], backend.cross_test

    def cross_test(*args):
        out = inner(*args)
        acc.append(_np(out))
        return out

    backend.cross_test = cross_test
    return acc


def final_state(state):
    from repro_torch.utils import tree_leaves
    return {"params": [_np(p) for p in tree_leaves(state.global_params)],
            "scores": [_np(t) for t in state.scores],
            "comp": None if state.comp_state is None
            else _np(state.comp_state),
            "gen": _np(state.gen.get_state())}


def play(trainer, data, rounds, state=None):
    """``rounds`` rounds from the seed (or ``state``): the per-round
    metrics and accuracy matrices, then the final state."""
    acc = record_acc(trainer.backend)
    state = trainer.init(0) if state is None else state
    metrics = []
    for _ in range(rounds):
        state, m = trainer.run_round(state, data)
        metrics.append({k: _np(v) for k, v in m.items()})
    backend = trainer.backend
    del backend.cross_test          # unwrap for a later play
    return dict(metrics=metrics, acc=acc, **final_state(state)), state


def local_trainer(fed_kw):
    from repro_torch.config import FedConfig
    from repro_torch.core.engine import FederatedTrainer
    model, tc = model_and_train()
    return FederatedTrainer(model, FedConfig(**fed_kw), tc, eval_batch=EVAL,
                            device="cpu")


def pod_trainer(group, fed_kw, exchange):
    from repro_torch.config import FedConfig
    from repro_torch.core.engine import PodTrainer
    model, tc = model_and_train()
    return PodTrainer(model, FedConfig(**fed_kw), tc, eval_batch=EVAL,
                      group=group, exchange=exchange)


def matrix_rank(group, cases, rounds):
    """One rank of the matrix: every case through ring and through
    allgather."""
    data = dataset()
    return {(name, exchange): play(pod_trainer(group, fed_kw, exchange),
                                   data, rounds)[0]
            for name, fed_kw in cases.items()
            for exchange in ("ring", "allgather")}


def resume_rank(group, ckpt_dir):
    """One rank of POD_SCRIPT's resume on each exchange: rank 0 saves at
    RESUME_SPLIT, the unbroken run goes on to RESUME_ROUNDS, and a trainer
    built anew restores the checkpoint on every rank and plays the rest.
    ``{exchange: {"unbroken": run, "resumed": run}}``."""
    import os

    from repro_torch.checkpoint import CheckpointManager
    resume_data = dataset(**RESUME_DATA)
    out = {}
    for exchange in ("ring", "allgather"):
        mgr = CheckpointManager(os.path.join(ckpt_dir, exchange))
        trainer = pod_trainer(group, RESUME_FED, exchange)
        _, state = play(trainer, resume_data, RESUME_SPLIT)
        trainer.save_checkpoint(mgr, state)
        unbroken, _ = play(trainer, resume_data,
                           RESUME_ROUNDS - RESUME_SPLIT, state)
        again = pod_trainer(group, RESUME_FED, exchange)
        restored, at = again.restore_checkpoint(mgr)
        assert at == RESUME_SPLIT and restored.round_idx == RESUME_SPLIT
        resumed, _ = play(again, resume_data, RESUME_ROUNDS - RESUME_SPLIT,
                          restored)
        out[exchange] = dict(unbroken=unbroken, resumed=resumed)
    return out


def population_fed():
    """N = 64, a cohort of C = 8 (sharded over the 4 ranks), 13 sign
    flippers, testers from the cohort."""
    return dict(num_users=64, cohort=8, participation=8 / 64,
                num_testers=4, num_malicious=13, attack="sign_flip",
                local_steps=2, rounds=3, seed=0)


def population_trainer(group=None):
    from repro_torch.config import FedConfig
    from repro_torch.core.engine import PopulationTrainer
    from repro_torch.data import make_synthetic_population
    model, tc = model_and_train()
    data = make_synthetic_population(64, per_client=32, seed=0,
                                     device="cpu")
    trainer = PopulationTrainer(model, FedConfig(**population_fed()), tc,
                                eval_batch=32, device="cpu",
                                testers_from_cohort=True, group=group)
    return trainer, data


def replay_rank(group, fed_kw, init_params, rounds_draws):
    """One rank of the reference replay: ``make_distributed_round`` (the
    ring) from the reference's converted init (numpy leaves) on the
    reference's draws (numpy), then the sharded population tier's
    rounds."""
    from repro_torch.config import FedConfig
    from repro_torch.core.engine import RoundDraws, make_distributed_round
    from repro_torch.core.scoring import init_scores
    from repro_torch.utils import tree_leaves, tree_map
    model, tc = model_and_train()
    data = dataset()
    round_fn = make_distributed_round(
        model, FedConfig(**fed_kw), tc, group, counts=data.train.counts,
        server_data=(data.server_x[:EVAL], data.server_y[:EVAL]))
    acc = record_acc(round_fn.backend)
    params = tree_map(torch.as_tensor, init_params)
    scores = init_scores(N, "cpu")
    r = group.rank
    tx, ty = data.test.xs[r, :EVAL], data.test.ys[r, :EVAL]
    metrics = []
    for i, d in enumerate(rounds_draws):
        draws = RoundDraws(**{k: torch.as_tensor(v) for k, v in d.items()})
        idx = draws.batch_idx[r]
        params, scores, m = round_fn(params, scores, data.train.xs[r][idx],
                                     data.train.ys[r][idx], tx, ty, draws,
                                     i)
        metrics.append({k: _np(v) for k, v in m.items()})
    trainer, pdata = population_trainer(group)
    population, _ = play(trainer, pdata, population_fed()["rounds"])
    return dict(acc=acc, metrics=metrics,
                params=[_np(p) for p in tree_leaves(params)],
                population=population)


def bitwise(a, b, what):
    """Two lists of arrays, element by element, bitwise."""
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} [{i}]")


def same_run(one, two, what):
    """Two runs' states and trajectories (:func:`play`), bitwise."""
    for key in ("params", "scores"):
        bitwise(one[key], two[key], f"{what}: {key}")
    for key in ("gen", "comp"):
        np.testing.assert_array_equal(one[key], two[key], f"{what}: {key}")
    bitwise(one["acc"], two["acc"], f"{what}: acc")
    for r, (m1, m2) in enumerate(zip(one["metrics"], two["metrics"])):
        assert m1.keys() == m2.keys()
        for k in m1:
            np.testing.assert_array_equal(m1[k], m2[k],
                                          err_msg=f"{what} round {r}: {k}")


def raise_on_rank_one(group):
    """Rank 1 raises while rank 0 waits in a collective."""
    if group.rank == 1:
        raise ValueError("rank one raises")
    group.all_gather(torch.zeros(1))
