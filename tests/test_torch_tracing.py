"""The port's spans and counters (``repro_torch.tracing``) on the CPU:

* spans nest with their parents' ids and rounds, a dense round's too,
  whose ``local_train`` runs under ``vmap(grad_and_value(...))``;
* off, nothing is recorded (the store stays empty, a span is the shared
  null context), and a ``torch.profiler`` trace of a round still holds
  the ``repro_torch.*`` annotations;
* a dense round, a chunk on the CPU loop and a population chunk are
  bitwise the same with tracing on and off;
* the store's bound (``tracing.dropped``), ``export`` clearing it, the
  counters, a graph replay's copies (on stand-in events: a capture needs
  the card), the kernels' build counters and the pod's exchange spans
  and counters on two gloo ranks.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.config import FedConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.engine import PopulationTrainer  # noqa: E402
from repro_torch.data import (  # noqa: E402
    MNIST_LIKE, make_federated_image_dataset, make_synthetic_population)
from repro_torch.kernels import build as build_mod  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import PackedTree, tree_leaves  # noqa: E402

MLP = dict(mlp_hidden=(16,))
TC = dict(optimizer="sgd", lr=0.1, schedule="constant", batch_size=8,
          grad_clip=0.0)
STEPS = 3
ROUND_STEPS = ("draw", "batches", "train", "attack", "cross_test", "scores",
               "aggregate")


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts and ends with tracing off and the store empty;
    torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.enable(False)
    tracing.export()
    yield
    tracing.enable(False)
    tracing.export()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mlp():
    model = build_model(get_config("fedtest-mlp-mnist").replace(**MLP))
    data = make_federated_image_dataset(MNIST_LIKE, 4, num_samples=400,
                                        global_test=64, seed=0,
                                        device="cpu")
    return model, data


def _trainer(mlp, rounds_per_call=1):
    fed = FedConfig(num_users=4, num_testers=2, num_malicious=1,
                    attack="random_weights", local_steps=STEPS)
    return FederatedTrainer(mlp[0], fed, TrainConfig(**TC), eval_batch=16,
                            device="cpu", rounds_per_call=rounds_per_call)


def _population(mlp, rounds_per_call):
    fed = FedConfig(num_users=12, num_testers=2, num_malicious=3,
                    attack="random_weights", local_steps=2,
                    participation=4 / 12, cohort=4)
    return PopulationTrainer(mlp[0], fed, TrainConfig(**TC), eval_batch=16,
                             device="cpu", rounds_per_call=rounds_per_call,
                             testers_from_cohort=True)


def _by_id(export):
    return {s["id"]: s for s in export["spans"]}


def _parent_name(export, span):
    parent = _by_id(export).get(span["parent"])
    return None if parent is None else parent["name"]


# ------------------------------------------------------------- nesting
def test_spans_nest_with_their_parents_and_rounds():
    tracing.enable()
    with tracing.span("outer", 7):
        with tracing.span("mid"):
            with tracing.span("leaf"):
                pass
        with tracing.span("other", 8):
            pass
    with tracing.span("alone"):
        pass
    out = tracing.export()
    got = {s["name"]: s for s in out["spans"]}
    assert [s["name"] for s in out["spans"]] == [
        "outer", "mid", "leaf", "other", "alone"]
    assert got["outer"]["parent"] is None and got["alone"]["parent"] is None
    assert got["mid"]["parent"] == got["outer"]["id"]
    assert got["leaf"]["parent"] == got["mid"]["id"]
    assert got["other"]["parent"] == got["outer"]["id"]
    assert [got[n]["round"] for n in ("outer", "mid", "leaf", "other")] == [
        7, 7, 7, 8]
    assert got["alone"]["round"] is None
    for s in out["spans"]:
        assert s["host_ms"] >= 0 and s["device_ms"] is None
        assert s["host_end_ns"] >= s["host_start_ns"] and not s["replay"]
    assert got["outer"]["host_start_ns"] <= got["leaf"]["host_start_ns"]
    assert got["leaf"]["host_end_ns"] <= got["outer"]["host_end_ns"]


def test_a_rounds_spans_nest_under_vmap_and_grad(mlp):
    """A dense round: its steps under ``round``, and ``local_train``'s
    three spans a step under ``train``, once a round for all clients
    (``vmap(grad_and_value(...))`` runs its Python once)."""
    trainer = _trainer(mlp)
    state = trainer.init(0)
    tracing.enable()
    state, _ = trainer.run_round(state, mlp[1])
    trainer.global_accuracy(state, mlp[1])
    out = tracing.export()
    names = [s["name"] for s in out["spans"]]
    assert names.count("round") == 1 and names.count("global_eval") == 1
    for step in ROUND_STEPS:
        (span,) = [s for s in out["spans"] if s["name"] == step]
        assert _parent_name(out, span) == "round", step
    for name, parent in (("train.step", "train"),
                         ("train.step.grad", "train.step"),
                         ("train.step.update", "train.step")):
        spans = [s for s in out["spans"] if s["name"] == name]
        assert len(spans) == STEPS, name
        assert {_parent_name(out, s) for s in spans} == {parent}
    assert {s["round"] for s in out["spans"]} == {0, 1}
    (glob,) = [s for s in out["spans"] if s["name"] == "global_eval"]
    assert glob["round"] == 1 and glob["parent"] is None


# ------------------------------------------------------------------ off
def test_off_records_nothing(mlp):
    trainer = _trainer(mlp)
    state, _ = trainer.run_round(trainer.init(0), mlp[1])
    trainer.global_accuracy(state, mlp[1])
    tracing.count("anything", 3)
    store = tracing._TRACER
    assert store.spans == [] and not store.counters
    assert store.stack == [] and store.pending == []
    assert tracing.span("a") is tracing.span("b")
    assert tracing.export() == {"spans": [], "counters": {}}


def test_the_profiler_sees_the_spans_with_tracing_off(mlp, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    trainer = _trainer(mlp)
    state = trainer.init(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = trainer.run_round(state, mlp[1])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = [e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith(tracing.PREFIX)]
    for name in ("round", "train", "train.step.grad", "train.step.update",
                 "cross_test", "aggregate"):
        assert tracing.PREFIX + name in marks, name
    assert marks.count(tracing.PREFIX + "train.step") == STEPS
    assert tracing._TRACER.spans == []


# --------------------------------------------------- the same arithmetic
def _run(mlp, kind, traced):
    tracing.enable(traced)
    if kind == "round":
        trainer = _trainer(mlp)
        state, metrics = trainer.run_round(trainer.init(0), mlp[1])
        metrics = [metrics]
    elif kind == "chunk":
        trainer = _trainer(mlp, rounds_per_call=2)
        state, metrics = trainer.run_chunk(trainer.init(0), mlp[1])
        metrics = [metrics]
    else:
        data = make_synthetic_population(12, per_client=32, global_test=32,
                                         seed=0, device="cpu")
        trainer = _population(mlp, 2)
        state, metrics = trainer.run_chunk(trainer.init(0), data)
        metrics = [metrics]
    tracing.enable(False)
    return state, metrics, tracing.export()


@pytest.mark.parametrize("kind", ["round", "chunk", "population"])
def test_tracing_on_and_off_give_the_same_bits(mlp, kind):
    off_state, off_metrics, off = _run(mlp, kind, False)
    on_state, on_metrics, on = _run(mlp, kind, True)
    assert off["spans"] == [] and on["spans"]
    one = tree_leaves(off_state.global_params) + list(off_state.scores)
    two = tree_leaves(on_state.global_params) + list(on_state.scores)
    for a, b in zip(one, two):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert torch.equal(off_state.gen.get_state(), on_state.gen.get_state())
    for m1, m2 in zip(off_metrics, on_metrics):
        assert m1.keys() == m2.keys()
        for k in m1:
            assert m1[k].numpy().tobytes() == m2[k].numpy().tobytes(), k
    if kind != "round":
        chunks = [s for s in on["spans"] if s["name"] == "chunk"]
        rounds = [s for s in on["spans"] if s["name"] == "round"]
        assert len(chunks) == 1 and [r["round"] for r in rounds] == [0, 1]
        assert {r["parent"] for r in rounds} == {chunks[0]["id"]}
    if kind == "population":
        names = [s["name"] for s in on["spans"]]
        assert names.count("draw") == names.count("shards") == 2
        assert names.count("noise") > 0


# ------------------------------------------------------ store and export
def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing._TRACER, "limit", 3)
    tracing.enable()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    out = tracing.export()
    assert [s["name"] for s in out["spans"]] == ["s0", "s1", "s2"]
    assert out["counters"] == {"tracing.dropped": 2}


def test_export_clears_the_store_and_counters():
    tracing.enable()
    with tracing.span("a"):
        tracing.count("n", 2)
        tracing.count("n")
    first = tracing.export()
    assert [s["name"] for s in first["spans"]] == ["a"]
    assert first["counters"] == {"n": 3}
    assert tracing.export() == {"spans": [], "counters": {}}
    # still on: a later span is kept with a fresh id
    with tracing.span("b"):
        pass
    (b,) = tracing.export()["spans"]
    assert b["id"] > first["spans"][0]["id"]


class _Event:
    """A stand-in for a CUDA event of a graph node, at a fixed time."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


def _graph_records(done=True):
    outer = tracing._Record("round", 100, None, None)
    inner = tracing._Record("draw", 101, 100, None)
    outer.start, outer.end = _Event(0.0), _Event(5.0, done)
    inner.start, inner.end = _Event(1.0), _Event(1.5, done)
    return [inner, outer]


def test_a_replays_copies_hang_under_the_replay_in_its_round():
    tracing.enable()
    records = _graph_records()
    with tracing.span("replay", 4):
        tracing.replayed(records)
    tracing.settle()
    out = tracing.export()
    got = {s["name"]: s for s in out["spans"]}
    assert got["round"]["parent"] == got["replay"]["id"]
    assert got["draw"]["parent"] == got["round"]["id"]
    assert got["round"]["round"] == got["draw"]["round"] == 4
    assert got["round"]["device_ms"] == 5.0
    assert got["draw"]["device_ms"] == 0.5
    assert got["draw"]["replay"] and not got["replay"]["replay"]
    assert got["draw"]["host_ms"] is None


def test_a_replay_not_finished_is_counted_unread_not_waited_for():
    tracing.enable()
    with tracing.span("replay", 0):
        tracing.replayed(_graph_records(done=False))
    tracing.settle()
    out = tracing.export()
    assert [s["name"] for s in out["spans"]] == ["replay"]
    assert out["counters"] == {"tracing.unread": 2}
    # off, a replay queues nothing
    tracing.enable(False)
    tracing.replayed(_graph_records())
    assert tracing._TRACER.pending == []


# -------------------------------------------------------------- kernels
def test_kernel_builds_and_loads_are_counted(monkeypatch, tmp_path):
    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_nvcc(cmd, **_):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return Done()

    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build_mod, "library_path",
                        lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(build_mod, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build_mod.subprocess, "run", fake_nvcc)
    tracing.enable()
    build_mod.build("k")
    build_mod.build("k")
    out = tracing.export()
    assert out["counters"] == {"kernels.built": 1, "kernels.built.k": 1,
                               "kernels.loaded": 1, "kernels.loaded.k": 1}
    assert [s["name"] for s in out["spans"]] == ["kernels.build"]


# ------------------------------------------------------------------ pod
def exchange_rank(group, traced):
    """One rank: an all-gather and a ring hop, with tracing on or off;
    what tracing recorded and what the hop brought in."""
    tracing.enable(traced)
    mine = torch.full((3,), float(group.rank))
    gathered = group.all_gather(mine[None])
    hop = group.hop_finish(group.hop_start(PackedTree.of({"w": mine})))
    tracing.enable(False)
    out = tracing.export()
    return ([(s["name"], s["parent"]) for s in out["spans"]],
            out["counters"], gathered.tolist(), hop.flats[0].tolist())


@pytest.mark.parametrize("traced", [True, False])
def test_the_pods_exchange_is_a_span_with_counters(traced):
    ranks = run_ranks(exchange_rank, 2, traced, join_timeout_s=120)
    for rank, (spans, counters, gathered, hop) in enumerate(ranks):
        assert gathered == [[0.0] * 3, [1.0] * 3]
        assert hop == [float((rank - 1) % 2)] * 3
        if traced:
            assert spans == [("pod.exchange", None)] * 3
            # gloo on the CPU stages nothing
            assert counters == {"pod.exchange.calls": 2}
        else:
            assert spans == [] and counters == {}


@pytest.mark.parametrize("backend,traced,syncs", [
    ("nccl", False, 0), ("nccl", True, 1), ("gloo", False, 1),
    ("gloo", True, 1)])
def test_a_collective_synchronises_only_for_tracing_or_staging(
        monkeypatch, backend, traced, syncs):
    """On the card, nccl waits for the device around a collective only
    while tracing times it; gloo stages through host memory and always
    does."""
    from repro_torch.launch.mesh import RankGroup
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    group = RankGroup(0, 1, "cuda", backend)
    tracing.enable(traced)
    group._sync()
    assert len(calls) == syncs
    assert group.staged == (backend == "gloo")
