"""Durability of the port: checkpoints, manifests, resume, SIGTERM, and
serving from a checkpoint; and a reference checkpoint converted.

Within the port (a small MLP on the CPU, inputs from seeds):

* the ``.npz`` round trip (bf16 stored as f32), atomic saves, ``keep``
  gc, a corrupt or foreign file skipped, a wrong leaf count refused, and
  another run's manifest refused;
* resume is bitwise (``torch.equal`` on every tensor and the generator
  state) for path A, under each fault, under ``full_collusion`` with
  trust and liars, and with ``int8``; ``should_stop`` drains;
* the train CLI killed by SIGTERM in a subprocess saves and exits, and
  ``--resume`` ends bitwise where an unbroken run ends;
* ``serve --ckpt-dir`` serves the newest step and refuses another arch.

Against the reference: the leaf path strings the two states share are
the reference's, and a checkpoint the reference wrote converts with its
params, scores, trust and ``round_idx`` bitwise, after which one more
round on replayed draws matches as ``tests/test_torch_round.py`` holds a
round (counts exact, floats at rtol=1e-4, atol=1e-5).
"""
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.checkpoint.serialization import _path_str  # noqa: E402
from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, LeafSpec, load_pytree, manifest_mismatches,
    read_leaves, save_pytree)
from repro_torch.checkpoint.serialization import flatten_with_paths  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import state_from_reference_checkpoint  # noqa: E402
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.data import MNIST_LIKE, make_federated_image_dataset  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from test_torch_round import (  # noqa: E402
    _assert_counts_match, _assert_round_matches, _replay)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TRUST = {"use_trust": True, "trust_decay": 0.3, "report_clip": 0.2}


@pytest.fixture(scope="module")
def tiny():
    model = build_model(get_config("fedtest-mlp-mnist").replace(
        mlp_hidden=(16,)))
    data = make_federated_image_dataset(MNIST_LIKE, 6, num_samples=900,
                                        global_test=100, seed=0,
                                        device="cpu")
    tc = TrainConfig(optimizer="sgd", lr=0.1, schedule="constant",
                     batch_size=8, grad_clip=0.0)
    return model, data, tc


def _trainer(tiny, model=None, **fed):
    base = dict(num_users=6, num_testers=2, num_malicious=1, local_steps=2,
                rounds=5)
    return FederatedTrainer(model or tiny[0], FedConfig(**{**base, **fed}),
                            tiny[2], eval_batch=16, device="cpu")


def _tensors(state):
    """Every tensor of a round state, by name, the generator's included."""
    out = {f"param {i}": t for i, t in enumerate(
        tree_leaves(state.global_params))}
    out.update({f"scores.{k}": v for k, v in state.scores._asdict().items()})
    out["gen_state"] = state.gen.get_state()
    if state.comp_state is not None:
        out["comp_state"] = state.comp_state
    return out


def _assert_bitwise(one, two):
    a, b = _tensors(one), _tensors(two)
    assert a.keys() == b.keys()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ
    assert (one.round_idx, one.seed) == (two.round_idx, two.seed)


# ------------------------------------------------------------ the format
def test_npz_round_trip_keeps_every_leaf(tiny, tmp_path):
    """A bf16 model's state: stored as f32, loaded back bitwise in bf16;
    ``rounds_seen`` comes back int32."""
    model = build_model(get_config("fedtest-mlp-mnist").replace(
        mlp_hidden=(16,), dtype="bfloat16"))
    trainer = _trainer(tiny, model=model, compressor="int8")
    state = trainer.init()
    sd = trainer.state_dict(state)
    assert all(a.dtype == np.float32 for a in tree_leaves(sd.global_params))
    save_pytree(sd, str(tmp_path / "s.npz"))
    back = trainer.load_state(load_pytree(trainer.state_template(),
                                          str(tmp_path / "s.npz")))
    _assert_bitwise(state, back)
    assert back.scores.rounds_seen.dtype == torch.int32
    assert all(t.dtype == torch.bfloat16
               for t in tree_leaves(back.global_params))
    paths = list(read_leaves(str(tmp_path / "s.npz")))
    assert paths == [p for p, _ in flatten_with_paths(sd)]


@pytest.mark.parametrize("compressor", ["identity", "int8"])
def test_path_strings_are_the_references(tiny, compressor):
    """Every leaf the two round states share has the reference's path
    string; the port adds the generator state and the seed, the
    reference has its threefry key."""
    fed = dict(num_users=6, num_testers=2, compressor=compressor)
    jmodel = jbuild_model(jget_config("fedtest-mlp-mnist").replace(
        mlp_hidden=(16,)))
    jtrainer = JTrainer(jmodel, JFedConfig(**fed), JTrainConfig(remat=False))
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jtrainer.init(jax.random.PRNGKey(0)))
    want = {_path_str(p): np.shape(v) for p, v in jflat}
    trainer = _trainer(tiny, **fed)
    got = {p: np.shape(v) for p, v in flatten_with_paths(
        trainer.state_dict(trainer.init()))}
    shared = set(want) & set(got)
    assert set(want) - shared == {".key"}
    assert set(got) - shared == {".gen_state", ".seed"}
    assert {".global_params/fc0/w", ".scores/.scores",
            ".scores/.rounds_seen", ".scores/.tester_trust",
            ".round_idx"} <= shared
    assert (".comp_state" in shared) == (compressor != "identity")
    assert all(want[p] == got[p] for p in shared)


def test_load_refuses_a_wrong_leaf_count_or_shape(tiny, tmp_path):
    trainer = _trainer(tiny)
    sd = trainer.state_dict(trainer.init())
    save_pytree(sd._replace(comp_state=np.zeros((6, 3), np.float32)),
                str(tmp_path / "extra.npz"))
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(trainer.state_template(), str(tmp_path / "extra.npz"))
    bad = sd._replace(scores=sd.scores._replace(
        scores=np.zeros((7,), np.float32)))
    with pytest.raises(ValueError, match="shape"):
        trainer.load_state(bad)
    other = _trainer(tiny, num_users=5, num_testers=2)
    with pytest.raises(ValueError, match="shape"):
        other.load_state(sd)


# ----------------------------------------------------------- the manager
def test_save_is_atomic(tiny, tmp_path, monkeypatch):
    """A writer that fails mid-file leaves neither a checkpoint nor a
    temporary file behind."""
    from repro_torch.checkpoint import manager as manager_mod
    trainer = _trainer(tiny)
    mgr = CheckpointManager(str(tmp_path))
    trainer.save_checkpoint(mgr, trainer.init(), step=1)

    def torn(tree, f):
        f.write(b"PK\x03\x04 half a file")
        raise OSError("disk full")

    monkeypatch.setattr(manager_mod, "save_pytree", torn)
    with pytest.raises(OSError, match="disk full"):
        trainer.save_checkpoint(mgr, trainer.init(), step=2)
    assert mgr.steps() == [1]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000001.npz",
                                           "manifest.json"]


def test_keep_collects_old_steps_and_ignores_foreign_files(tiny, tmp_path):
    trainer = _trainer(tiny)
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every=2)
    (tmp_path / "ckpt_tmp.npz").write_bytes(b"x")
    (tmp_path / "notes.txt").write_text("x")
    state = trainer.init()
    for step in range(1, 6):
        if mgr.should_save(step):
            trainer.save_checkpoint(mgr, state, step=step)
    trainer.save_checkpoint(mgr, state, step=5)
    assert mgr.steps() == [4, 5] and mgr.latest_step() == 5
    assert (tmp_path / "ckpt_tmp.npz").exists()
    assert not mgr.should_save(0) and mgr.should_save(6)
    assert not mgr.should_save(7)


def test_restore_skips_a_corrupt_or_foreign_checkpoint(tiny, tmp_path):
    trainer = _trainer(tiny)
    mgr = CheckpointManager(str(tmp_path), keep=5)
    state = trainer.init()
    trainer.save_checkpoint(mgr, state, step=1)
    trainer.save_checkpoint(mgr, state, step=2)
    (tmp_path / "ckpt_00000002.npz").write_bytes(b"not a zip file")
    # a checkpoint of another run (another model) is foreign too
    other = _trainer(tiny, model=build_model(get_config(
        "fedtest-mlp-mnist").replace(mlp_hidden=(8,))))
    mgr.save(3, other.state_dict(other.init()))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        back, at = trainer.restore_checkpoint(mgr)
    assert at == 1 and len(caught) == 2
    _assert_bitwise(state, back)
    for step in (2, 3):
        os.remove(tmp_path / f"ckpt_{step:08d}.npz")
    (tmp_path / "ckpt_00000001.npz").write_bytes(b"")
    with pytest.warns(RuntimeWarning), \
            pytest.raises(FileNotFoundError, match="no restorable"):
        trainer.restore_checkpoint(mgr)


def test_restore_refuses_another_runs_manifest(tiny, tmp_path):
    trainer = _trainer(tiny)
    mgr = CheckpointManager(str(tmp_path))
    trainer.save_checkpoint(mgr, trainer.init())
    # rounds is the run's length, not its identity
    _trainer(tiny, rounds=9).restore_checkpoint(mgr)
    with pytest.raises(ValueError, match="fed.score_power"):
        _trainer(tiny, score_power=2.0).restore_checkpoint(mgr)
    with pytest.raises(ValueError, match="fed.fault"):
        _trainer(tiny, fault="dropout").restore_checkpoint(mgr)
    # nor does another run save into the directory
    other = _trainer(tiny, score_power=2.0)
    with pytest.raises(ValueError, match="fed.score_power"):
        other.save_checkpoint(mgr, other.init(), step=5)
    assert mgr.steps() == [0]
    saved = mgr.read_manifest()
    assert manifest_mismatches(saved, saved) == []
    assert "rounds" not in saved["fed"] and saved["use_trust"] is False


# --------------------------------------------------------------- resume
RESUME_CASES = {
    "path_a": {},
    "dropout": dict(fault="dropout", fault_rate=0.3),
    "straggler_deadline": dict(fault="straggler_deadline"),
    "targeted": dict(fault="targeted",
                     fault_kwargs={"size": 2, "start_round": 2}),
    "full_collusion_trust": dict(coalition="full_collusion",
                                 coalition_size=2, attack="none",
                                 attack_scale=8.0, lying_testers=1,
                                 aggregator_kwargs=TRUST),
    "int8": dict(compressor="int8", participation=0.7),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_is_bitwise(tiny, tmp_path, case):
    """5 rounds unbroken against 3 rounds, a checkpoint, a new trainer
    restoring it, and 2 more."""
    data = tiny[1]
    whole, hist = _trainer(tiny, **RESUME_CASES[case]).run(data)
    mgr = CheckpointManager(str(tmp_path), save_every=1)
    first = _trainer(tiny, **RESUME_CASES[case])
    part, _ = first.run(data, rounds=3, ckpt=mgr)
    assert mgr.steps() == [1, 2, 3]
    again = _trainer(tiny, **RESUME_CASES[case])
    state, at = again.restore_checkpoint(mgr)
    assert at == 3
    _assert_bitwise(part, state)
    resumed, rest = again.run(data, state=state)
    _assert_bitwise(whole, resumed)
    assert rest["round"] == [4, 5] and hist["round"] == [1, 2, 3, 4, 5]
    assert rest["global_accuracy"] == hist["global_accuracy"][3:]
    if case == "full_collusion_trust":
        assert (whole.scores.tester_trust < 1).any()
    if case == "int8":
        assert whole.comp_state.abs().sum() > 0


def test_should_stop_drains_at_a_round_boundary(tiny):
    trainer = _trainer(tiny)
    asked = []

    def should_stop():
        asked.append(1)
        return len(asked) > 2

    state, hist = trainer.run(tiny[1], rounds=10, should_stop=should_stop)
    assert state.round_idx == 2 and hist["round"] == [1, 2]
    state, hist = trainer.run(tiny[1], rounds=2, eval_every=4, state=state)
    assert state.round_idx == 2 and hist["round"] == []


CLI = ["--device", "cpu", "--arch", "fedtest-mlp-mnist", "--dataset",
       "mnist_like", "--scenario", "full_collusion_vs_fedtest", "--fault",
       "straggler_deadline", "--users", "6", "--testers", "2",
       "--coalition-size", "2", "--samples", "900", "--local-steps", "2",
       "--batch", "8"]


def test_cli_resumes_bitwise_after_sigterm(tmp_path):
    """The CLI in a subprocess, killed by SIGTERM once its first
    checkpoint is on disk: it saves the round it reached and exits with
    the reference's message; ``--resume`` then ends where an unbroken
    run of the same flags ends, bitwise."""
    from repro_torch.launch.train import build, main, parse_args
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI,
         "--rounds", "100000", "--ckpt-dir", str(ckpt), "--ckpt-every",
         "1", "--out", str(tmp_path / "out")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while not list(ckpt.glob("ckpt_*.npz")):
            assert proc.poll() is None and time.time() < deadline, \
                proc.communicate()
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 1, (out, err)
    stopped = int(re.search(r"interrupted at round (\d+) \(state saved\)",
                            err).group(1))
    assert "SIGTERM" in out
    assert CheckpointManager(str(ckpt)).latest_step() == stopped >= 1
    target = stopped + 2
    main(CLI + ["--rounds", str(target), "--ckpt-dir", str(ckpt),
                "--resume", "--out", str(tmp_path / "out")])
    trainer, data, _ = build(parse_args(CLI + ["--rounds", str(target)]))
    whole, _ = trainer.run(data)
    resumed, at = trainer.restore_checkpoint(CheckpointManager(str(ckpt)))
    assert at == target
    _assert_bitwise(whole, resumed)
    hist = json.loads(next((tmp_path / "out").glob("*.json")).read_text())
    assert hist["config"]["resumed"] and hist["config"]["fault"] == \
        "straggler_deadline"
    assert hist["round"] == [stopped + 1, target]


# ---------------------------------------------------------------- serve
def test_serve_reads_the_newest_checkpoint_and_refuses_another_arch(
        tiny, tmp_path):
    cfg = reduce_for_smoke(get_config("qwen2-0.5b")).replace(dtype="float32")
    trainer = _trainer(tiny, model=build_model(cfg))
    mgr = CheckpointManager(str(tmp_path))
    state = trainer.init()
    trainer.save_checkpoint(mgr, state, step=1)
    newer = state._replace(global_params=tree_map(
        lambda t: t * 2, state.global_params))
    trainer.save_checkpoint(mgr, newer, step=4)
    args = ["--device", "cpu", "--smoke", "--batch", "2", "--prompt-len",
            "8", "--gen", "3", "--ckpt-dir", str(tmp_path)]
    model, params, batch, gen = serve_mod.build(serve_mod.parse_args(args))
    for got, want in zip(tree_leaves(params),
                         tree_leaves(newer.global_params)):
        assert torch.equal(got, want)
    res = serve_mod.main(args)
    direct = serve_mod.serve(model, newer.global_params, batch, 3, 0.0,
                             gen)
    assert torch.equal(res["tokens"], direct["tokens"])
    with pytest.raises(SystemExit, match="refusing"):
        serve_mod.build(serve_mod.parse_args(
            ["--device", "cpu", "--smoke", "--arch", "mamba2-2.7b",
             "--ckpt-dir", str(tmp_path)]))
    with pytest.raises(FileNotFoundError, match="within"):
        serve_mod.build(serve_mod.parse_args(
            ["--device", "cpu", "--smoke", "--ckpt-dir",
             str(tmp_path / "empty")]))
    # only the params are read: no manifest is needed, and a newer torn
    # file is skipped
    os.remove(tmp_path / "manifest.json")
    (tmp_path / "ckpt_00000009.npz").write_bytes(b"torn")
    with pytest.warns(RuntimeWarning, match="skipping corrupt"):
        params, step = serve_mod.load_serving_params(
            CheckpointManager(str(tmp_path)), model, device="cpu")
    assert step == 4 and all(torch.equal(got, want) for got, want in zip(
        tree_leaves(params), tree_leaves(newer.global_params)))


def test_load_serving_params_needs_a_device(tmp_path):
    """The loader names no default device: a call without one raises
    before it reads the directory."""
    model = build_model(reduce_for_smoke(get_config("qwen2-0.5b")).replace(
        dtype="float32"))
    with pytest.raises(TypeError, match="device"):
        serve_mod.load_serving_params(CheckpointManager(str(tmp_path)),
                                      model)


# ------------------------------------------------------ the reference's
def test_reference_checkpoint_converts_and_plays_on(tmp_path):
    """One reference round with tester trust, its checkpoint written by
    the reference's manager and read by the port: params, scores, trust,
    ``rounds_seen`` and ``round_idx`` bitwise; then round 1 in both
    packages on the reference's draws."""
    def convert(jtrainer, ttrainer, jstate, jdata):
        jstate, _ = jtrainer.run_round(jstate, jdata)
        path = jtrainer.save_checkpoint(JCheckpointManager(str(tmp_path)),
                                        jstate)
        tstate = state_from_reference_checkpoint(path, ttrainer)
        pairs = list(zip(tree_leaves(tstate.global_params),
                         jax.tree_util.tree_leaves(jstate.global_params)))
        pairs += [(getattr(tstate.scores, f), getattr(jstate.scores, f))
                  for f in tstate.scores._fields]
        for got, want in pairs:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tstate.scores.rounds_seen.dtype == torch.int32
        assert tstate.round_idx == int(jstate.round_idx) == 1
        assert (tstate.scores.tester_trust < 1).any()
        other = FederatedTrainer(
            ttrainer.model, dataclasses.replace(ttrainer.fed,
                                                score_power=2.0),
            ttrainer.train, device="cpu")
        with pytest.raises(ValueError, match="fed.score_power"):
            state_from_reference_checkpoint(path, other)
        return jstate, tstate

    r = _replay(aggregator_kwargs=TRUST, convert=convert)
    _assert_counts_match(r)
    _assert_round_matches(r)
    assert r["tnew"].round_idx == 2


def test_reference_manifest_of_another_model_is_refused(tmp_path):
    """``state_from_reference_checkpoint`` holds the reference's manifest
    to the trainer's ``model`` field too (the two packages' ModelConfig
    have the same fields): the manifest of this very model passes to the
    checkpoint's leaves (absent here), that of another MLP is refused
    before any leaf is read, naming the field."""
    from repro.checkpoint.manifest import run_manifest as jrun_manifest
    fed = dict(num_users=4, num_testers=2)
    tc = dict(optimizer="sgd", lr=0.1, schedule="constant", batch_size=8,
              grad_clip=0.0)
    small = dict(mlp_hidden=(16,))
    ttrainer = FederatedTrainer(
        build_model(get_config("fedtest-mlp-mnist").replace(**small)),
        FedConfig(**fed), TrainConfig(**tc), device="cpu")
    path = str(tmp_path / "ckpt_00000001.npz")

    def write(**model_kw):
        jcfg = jget_config("fedtest-mlp-mnist").replace(**{**small,
                                                           **model_kw})
        with open(tmp_path / "manifest.json", "w") as f:
            json.dump(jrun_manifest(jcfg, JFedConfig(**fed),
                                    JTrainConfig(remat=False, **tc)), f)

    write()
    with pytest.raises(FileNotFoundError):
        state_from_reference_checkpoint(path, ttrainer)
    write(mlp_hidden=(32,))
    with pytest.raises(ValueError, match=r"model\.mlp_hidden"):
        state_from_reference_checkpoint(path, ttrainer)
