"""One run of one cell: set-up, the first rounds (which the reference
follows), the measured window, with ``--trace 1`` a traced stretch and the
step timers, then the comparison that decides ``correct``, and the result
line.

The window drives the program as its users do. ``eager`` traffic plays
``FederatedTrainer.run_round`` and then the host reads of
``global_accuracy``, the local loss and the malicious weight, as
``FederatedTrainer.run`` does with ``eval_every`` 1; ``chunks`` traffic
plays ``PopulationTrainer.run_chunk`` (one CUDA graph of a round, replayed
``rounds_per_call`` times) and reads the same at each chunk boundary.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from fedbench import peaks, trace as trace_mod, traffic as traffic_mod
from fedbench import weights as weights_mod
from fedbench.reference import compare as compare_mod
from fedbench.reference import fedtest as fedtest_ref
from fedbench.reference import philox as philox_ref
from fedbench.reference import population as population_ref

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the rows the port's ``global_accuracy`` evaluates, at most
EVAL_ROWS = 2048
SPANS = {"train": "train", "apply_attack": "attack",
         "cross_test": "cross_test", "weighted_sum": "aggregate"}


# ------------------------------------------------------------------ loading
def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """A cell's entry in ``BENCHMARK.json`` and its files, found by name;
    ``shrink`` replaces traffic fields (the CPU tests' small sizes)."""

    def __init__(self, root: str, name: str, shrink: Optional[dict] = None,
                 config_shrink: Optional[dict] = None):
        self.root, self.name = root, name
        self.bench = _json(root, "BENCHMARK.json")
        entry = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        here = os.path.join(root, "fedbench")
        self.workload = _json(here, "workloads", f"{name}.json")
        self.config = _json(here, "configs", f"{self.entry['config']}.json")
        self.traffic = _json(here, "traffic", f"{self.entry['traffic']}.json")
        for key, value in (shrink or {}).items():
            if isinstance(value, dict):
                self.traffic[key] = {**self.traffic[key], **value}
            else:
                self.traffic[key] = value
        if config_shrink:
            self.config = {**self.config, **config_shrink}
            port = dict(self.config["port"])
            port["replace"] = {**port["replace"],
                               **config_shrink.get("port_replace", {})}
            self.config["port"] = port

    def metrics(self, traced: bool) -> List[dict]:
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads",
                                                       [self.name])]

    def reader(self, metric: str) -> Callable:
        """``metrics/<metric>.py``; where there is none, the reader of the
        quantity, the name before its last dot (``train_ms`` for
        ``train_ms.lm``)."""
        here = os.path.join(self.root, "fedbench", "metrics")
        name = metric
        if not os.path.exists(os.path.join(here, f"{name}.py")):
            name = metric.rsplit(".", 1)[0]
        spec = importlib.util.spec_from_file_location(
            f"fedbench_metric_{name.replace('.', '_')}",
            os.path.join(here, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def family_module(kind: str, family: str):
    return importlib.import_module(f"fedbench.{kind}.{family}")


# ------------------------------------------------------------------ program
class Program:
    """The port built on the benchmark's inputs: the trainer, the dataset
    view and the round state, with the call a round of the window makes
    (``play``) and the eager round beside it (``eager``)."""

    def __init__(self, cell: Cell, data: dict, params, seed: int, device):
        from repro_torch.config import FedConfig, TrainConfig
        from repro_torch.configs import get_config
        from repro_torch.core.engine.driver import RoundState
        from repro_torch.core.scoring import init_scores
        from repro_torch.models import build_model

        traffic, port = cell.traffic, cell.config["port"]
        model = build_model(get_config(port["arch"]).replace(
            **port["replace"]))
        want = {k: tuple(v.shape) for k, v in weights_mod.leaves(params)}
        got = {k: tuple(v) for k, v in weights_mod.leaves(
            model.param_shapes())}
        if want != got:
            raise ValueError(f"the port's {port['arch']} has other leaves "
                             f"than the configuration: {got} vs {want}")
        fed = FedConfig(**traffic["fed"])
        self.trainer = self.make_trainer(model, fed,
                                         TrainConfig(**traffic["train"]),
                                         traffic, device)
        self.data = self.make_data(data, fed, traffic)
        self.state = RoundState(
            global_params=params,
            scores=init_scores(fed.num_users, device), round_idx=0,
            gen=traffic_mod.generator(seed, traffic_mod.ROUNDS, device),
            seed=traffic_mod.stream_seed(seed, traffic_mod.ROUNDS))
        self.rounds_per_play = self.trainer.rounds_per_call

    def make_trainer(self, model, fed, train, traffic, device):
        from repro_torch.core.engine.driver import FederatedTrainer
        return FederatedTrainer(model, fed, train,
                                eval_batch=traffic["eval_rows"],
                                device=device)

    def make_data(self, data, fed, traffic):
        from repro_torch.data.pipeline import ClientData, FederatedDataset
        test_rows = data["test_x"].shape[1]
        return FederatedDataset(
            train=ClientData(data["train_x"], data["train_y"],
                             data["counts"]),
            test=ClientData(data["test_x"], data["test_y"],
                            torch.full_like(data["counts"], test_rows)),
            global_x=data["global_x"], global_y=data["global_y"],
            server_x=data["server_x"], server_y=data["server_y"])

    @property
    def backend(self):
        return self.trainer.backend

    def eager(self) -> float:
        """One round and its host reads, as ``FederatedTrainer.run``
        makes them; returns the local loss."""
        self.state, metrics = self.trainer.run_round(self.state, self.data)
        self.trainer.global_accuracy(self.state, self.data)
        float(metrics["malicious_weight"])
        return float(metrics["local_loss"])

    play = eager


class PopulationProgram(Program):
    """The population tier on the benchmark's keyed population: a
    ``PopulationTrainer`` whose play is a chunk of ``rounds_per_call``
    replays of one CUDA graph of its round (``run_chunk``), read at the
    chunk's end as ``FederatedTrainer.run`` reads it."""

    def make_trainer(self, model, fed, train, traffic, device):
        from repro_torch.core.engine import PopulationTrainer
        return PopulationTrainer(
            model, fed, train, eval_batch=traffic["eval_rows"],
            device=device, rounds_per_call=traffic["rounds_per_call"],
            crosstest_block=traffic["crosstest_block"],
            testers_from_cohort=traffic["testers_from_cohort"])

    def make_data(self, data, fed, traffic):
        from repro_torch.data.population import SyntheticPopulation
        pop = traffic["data"]
        return SyntheticPopulation(
            philox=data["shard_key"], protos=data["protos"],
            global_x=data["global_x"], global_y=data["global_y"],
            server_x=data["server_x"], server_y=data["server_y"],
            num_clients=fed.num_users, per_client=pop["per_client"],
            noise=pop["noise"])

    def play(self) -> float:
        """A chunk and its host reads; the chunk's summed local loss."""
        self.state, metrics = self.trainer.run_chunk(self.state, self.data)
        self.trainer.global_accuracy(self.state, self.data)
        float(metrics["malicious_weight"][-1])
        return float(metrics["local_loss"].sum())


PROGRAMS = {"eager": Program, "chunks": PopulationProgram}


def wrap(obj, name: str, around: Callable) -> Callable[[], None]:
    """Put ``around(original)`` over ``obj.name``; returns the undo."""
    original = getattr(obj, name)
    setattr(obj, name, around(original))
    return lambda: delattr(obj, name)


def checked_rounds(program: Program, params0, rounds: int) -> dict:
    """The first ``rounds`` rounds through the window's own call, keeping
    what the reference is held to: of the first round, the clients'
    losses, the trained and the attacked models, the accuracies, the
    weights and the new global model, as each step returned them; of the
    first global eval, the label's log-probability at each position by
    the program's own forward, with the parameters it evaluated
    (``eval``); each play's leaf changes from the initial model; and each
    play's wall time.

    A chunk on the card captures its round in a CUDA graph, after an
    eager warm-up round whose results it undoes; its first replay is the
    first round again. The steps' outputs of the capture are the graph's
    own buffers, so they are held, and copied once the first replay has
    written them: the record is of a replayed round, as the window plays
    it."""
    first: Dict[str, Any] = {}
    held: Dict[str, Any] = {}
    calls = {m: 0 for m in ("train", "apply_attack", "cross_test",
                            "weighted_sum")}
    trainer = program.trainer
    captured = (program.rounds_per_play > 1
                and getattr(trainer, "device", None) is not None
                and trainer.device.type == "cuda")
    want = 2 if captured else 1

    def keep(step):
        def around(fn):
            def run(*a, **k):
                out = fn(*a, **k)
                calls[step] += 1
                if calls[step] == want:
                    if captured:
                        held[step] = (a, out)
                    else:
                        first[step] = _record(step, a, out, params0)
                return out
            return run
        return around

    loads = [0]

    def after_first_replay(fn):
        # a chunk loads its eval rows before the capture and before each
        # replay: the third load follows the first replay
        def run(*a, **k):
            loads[0] += 1
            if loads[0] == 3:
                for step, (args, out) in held.items():
                    first[step] = _record(step, args, out, params0)
                held.clear()
            return fn(*a, **k)
        return run

    undo = [wrap(program.backend, m, keep(m)) for m in calls]
    undo.append(wrap(trainer, "global_accuracy", keep_eval(program, first)))
    if captured:
        undo.append(wrap(trainer, "_load_eval_rows", after_first_replay))
    norms, walls = [], []
    try:
        for _ in range(-(-rounds // program.rounds_per_play)):
            t = time.perf_counter()
            program.play()
            walls.append(time.perf_counter() - t)
            norms.append(compare_mod.change_norms(
                program.state.global_params, params0))
    finally:
        for u in undo:
            u()
    weights, params, first_norms = first["weighted_sum"]
    trained, models = first["apply_attack"]
    return {"losses": first["train"], "trained": trained, "models": models,
            "acc": first["cross_test"], "weights": weights,
            "params": params, "eval": first["eval"],
            "norms": [first_norms] + norms, "walls": walls}


def keep_eval(program: Program, first: dict) -> Callable:
    """Around ``global_accuracy``: in its first call, the logits of the
    program's own forward (the eval function's) reduced to each
    position's label log-probability, kept in ``first["eval"]`` with the
    parameters evaluated."""
    rp = program.trainer.program
    model = rp.model

    def around(fn):
        def run(*a, **k):
            if "eval" in first:
                return fn(*a, **k)
            evaluate = rp.eval_fn

            def recording(params, bx, by):
                forward = model.forward_train

                def kept(p, batch):
                    logits = forward(p, batch)
                    first["eval"] = {
                        **compare_mod.eval_stats(logits, by),
                        "params": weights_mod.tree_from(
                            {n: t.detach().to("cpu", copy=True)
                             for n, t in weights_mod.leaves(params)})}
                    return logits
                # the model is a frozen dataclass: set past its guard
                object.__setattr__(model, "forward_train", kept)
                try:
                    return evaluate(params, bx, by)
                finally:
                    object.__delattr__(model, "forward_train")
            rp.eval_fn = recording
            try:
                return fn(*a, **k)
            finally:
                rp.eval_fn = evaluate
        return run
    return around


def _record(step: str, args, out, params0):
    """What the first call of a round step is held to, copied; models to
    host memory, so that the copies add nothing to the device's peak."""
    if step == "train":
        return out[1].detach().clone()
    if step == "apply_attack":
        return _copies(args[2]), _copies(out)
    if step == "cross_test":
        return out.detach().clone()
    return (args[1].detach().clone(),
            weights_mod.tree_from({k: t.detach().to("cpu", copy=True)
                                   for k, t in weights_mod.leaves(out)}),
            compare_mod.change_norms(out, params0))


def _copies(models) -> List[dict]:
    """Each slot's tree of a stacked tree (a cohort's ``stack``), copied
    to host memory."""
    stacked = getattr(models, "stack", models)
    flat = {k: t.detach().to("cpu", copy=True)
            for k, t in weights_mod.leaves(stacked)}
    return fedtest_ref.unstack(flat, next(iter(flat.values())).shape[0])


# ------------------------------------------------------------------- window
def window(play: Callable[[], float], seconds: float, rounds_per_play: int):
    """Plays until ``seconds`` have passed (the play under way finishes);
    returns (seconds, each play's seconds, the rounds of plays whose loss
    is not finite)."""
    times, failed = [], 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        loss = play()
        t1 = time.perf_counter()
        times.append(t1 - t)
        failed += 0 if math.isfinite(loss) else rounds_per_play
        if t1 - t0 >= seconds:
            return t1 - t0, times, failed


def traced_stretch(program: Program, plays: int, device, ops=()) -> Dict:
    """``plays`` plays under ``torch.profiler``, each call into the
    program's steps inside a ``fedbench::<step>`` annotation; the trace
    reduced (``trace.reduce``)."""
    from torch.profiler import ProfilerActivity, record_function

    def span(label):
        def around(fn):
            def run(*a, **k):
                with record_function(f"fedbench::{label}"):
                    return fn(*a, **k)
            return run
        return around

    from repro_torch.kernels.weighted_aggregate import ops as aggregate_ops
    undo = [wrap(program.backend, m, span(s)) for m, s in SPANS.items()]
    undo.append(wrap(program.trainer, "global_accuracy", span("global_eval")))
    # the kernel's own launches: the port's call of the grouped kernel
    original = aggregate_ops._aggregate_group
    aggregate_ops._aggregate_group = span("weighted_aggregate")(original)
    undo.append(lambda: setattr(aggregate_ops, "_aggregate_group", original))
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        program.play()
        _sync(device)
        out = {**_profiled(program.play, plays, acts, ops), "plays": plays,
               "span_rounds": plays * program.rounds_per_play}
        if program.rounds_per_play > 1:
            # a replay runs no Python: the calls' spans come from an
            # eager round of the same trainer
            out["spans"] = _profiled(program.eager, 1, acts, ops)["spans"]
            out["span_rounds"] = 1
    finally:
        for u in undo:
            u()
    return out


def _profiled(play: Callable, plays: int, acts, ops) -> Dict:
    from torch.profiler import profile, record_function

    with profile(activities=acts) as prof:
        with record_function(trace_mod.WINDOW):
            for _ in range(plays):
                play()
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.reduce(path, ops)
    finally:
        os.unlink(path)


def step_timers(program: Program, plays: int) -> Dict[str, List[float]]:
    """Device ms of local training and of cross-testing in each of
    ``plays`` eager rounds: CUDA events recorded around the calls, read
    after the rounds, with no synchronisation between them."""
    marks: Dict[str, list] = {"train": [], "cross_test": []}

    def timed(key):
        def around(fn):
            def run(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                marks[key].append((start, end))
                return out
            return run
        return around

    undo = [wrap(program.backend, k, timed(k)) for k in marks]
    try:
        for _ in range(plays):
            program.eager()
        torch.cuda.synchronize()
    finally:
        for u in undo:
            u()
    return {k: [s.elapsed_time(e) for s, e in v] for k, v in marks.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    """Return what the freed program held to the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- reference
def reference_rounds(cell: Cell, seed: int, device, precision="float32"):
    """The reference's own checked rounds on inputs made anew from the
    seed, each with its leaf ``norms`` of change; and the reference model
    and inputs, for judging a record."""
    cfg, traffic = cell.config, cell.traffic
    ref = family_module("reference", cfg["family"])
    data = traffic_mod.make_data(traffic, cfg, seed, device)
    params0 = weights_mod.make_params(ref.param_specs(cfg), seed, device)
    model = ref.model(cfg, precision)
    gen = traffic_mod.generator(seed, traffic_mod.ROUNDS, device)
    rounds = fedtest_ref.run_rounds
    if traffic["driver"] == "chunks":
        rounds = population_ref.run_rounds
        data["noise_key"] = philox_ref.key_of(
            traffic_mod.stream_seed(seed, traffic_mod.ROUNDS),
            population_ref.NOISE_STREAM)
        data["params0"] = params0
    with fedtest_ref.precision(precision):
        recs = rounds(model, params0, data, traffic, gen,
                      traffic["checked_rounds"])
    for r in recs:
        r["norms"] = compare_mod.change_norms(r["params"], params0)
    return recs, model, data


def judge(cell: Cell, seed: int, device, prog: dict) -> Dict[str, float]:
    """The numbers of a program's record (``checked_rounds``) against the
    float32 reference."""
    ref, model, data = reference_rounds(cell, seed, device)
    def to_device(tree):
        return weights_mod.tree_from({k: t.to(device) for k, t in
                                      weights_mod.leaves(tree)})

    prog = {**prog, "params": to_device(prog["params"]),
            "eval": {**prog["eval"],
                     "params": to_device(prog["eval"]["params"])},
            **{key: [to_device(m) for m in prog[key]]
               for key in ("trained", "models")}}
    numbers = (population_ref.numbers if cell.traffic["driver"] == "chunks"
               else compare_mod.numbers)
    with fedtest_ref.precision("float32"):
        return numbers(prog, ref, model, data, cell.traffic)


def control_record(cell: Cell, seed: int, device,
                   precision: Optional[str] = None) -> dict:
    """The reference computed one precision below the configuration's
    (``control``), or in ``precision``, as a program's record; its global
    eval is of the first round's model, on the rows the program's
    evaluates."""
    precision = precision or cell.config["control"]
    recs, model, data = reference_rounds(cell, seed, device,
                                         precision=precision)
    first = recs[0]
    rows = min(EVAL_ROWS, data["global_x"].shape[0])
    with fedtest_ref.precision(precision):
        stats = compare_mod.reference_eval_stats(
            model, first["params"], data["global_x"][:rows],
            data["global_y"][:rows])
    losses = first["losses"]
    if "idx" in first:
        # a cohort round reports its members' losses among N clients
        members = first["idx"][first["valid"]]
        losses = torch.zeros(first["acc"].shape[1], device=losses.device
                             ).index_copy_(0, members, losses)
    return {"losses": losses, "trained": first["trained"],
            "models": first["models"], "acc": first["acc"],
            "weights": first["weights"], "params": first["params"],
            "eval": {**stats, "params": first["params"]},
            "norms": [r["norms"] for r in recs]}


# --------------------------------------------------------------------- run
def build(cell: Cell, seed: int, device):
    """The benchmark's inputs and the program on them."""
    cfg = cell.config
    ref = family_module("reference", cfg["family"])
    data = traffic_mod.make_data(cell.traffic, cfg, seed, device)
    params0 = weights_mod.make_params(ref.param_specs(cfg), seed, device)
    program = PROGRAMS[cell.traffic["driver"]](cell, data, params0, seed,
                                               device)
    return program, params0


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, log=print, plant: Optional[Callable] = None
        ) -> Dict[str, Any]:
    """Every step of a run but the look for a card and the printing of
    the result; ``plant(program)`` (the fault tests) breaks the program
    before its first round."""
    setup: Dict[str, float] = {"torch_and_card": time.perf_counter()
                               - t_start}
    t = time.perf_counter()
    import repro_torch.core.engine  # noqa: F401  (the program's imports)
    setup["imports"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        from repro_torch.kernels.build import load_library
        for k in cell.workload.get("kernels", []):
            load_library(k)
    setup["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    program, params0 = build(cell, seed, device)
    _sync(device)
    setup["inputs_and_build"] = time.perf_counter() - t
    if plant is not None:
        plant(program)
    t = time.perf_counter()
    checked = checked_rounds(program, params0, cell.traffic["checked_rounds"])
    _sync(device)
    setup["first_rounds"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in setup.items())
        + f"; setup_s {setup_s:.3f}; first rounds "
        + ", ".join(f"{w:.3f}" for w in checked["walls"]) + " s")

    launches0 = launch_counts(cell)
    win_s, times, failed = window(program.play, seconds,
                                  program.rounds_per_play)
    rounds = len(times) * program.rounds_per_play
    ms = sorted(1e3 * x for x in times)
    log(f"window: {rounds} rounds in {win_s:.3f} s; a play's ms min "
        f"{ms[0]:.2f}, median {statistics.median(ms):.2f}, max {ms[-1]:.2f}"
        "; launches "
        + json.dumps({k: v - launches0[k]
                      for k, v in launch_counts(cell).items()}))
    record = {"cell": cell.name, "config": cell.config,
              "traffic": cell.traffic, "setup_s": setup_s, "setup": setup,
              "window": {"seconds": win_s, "play_s": times,
                         "rounds": rounds,
                         "rounds_per_play": program.rounds_per_play},
              "work": family_module("work", cell.config["family"])
              .round_work(cell.config, cell.traffic),
              "peak_flops": peaks.PEAK_FLOPS[cell.config["mfu_peak"]],
              "hbm_bytes_per_s": peaks.HBM_BYTES_PER_S,
              "trace": None, "steps": None}
    if traced:
        record["trace"] = traced_stretch(
            program, cell.traffic["trace_plays"], device,
            cell.workload.get("trace_ops", ()))
        if device.type == "cuda":
            record["steps"] = step_timers(program,
                                          cell.traffic["timer_plays"])
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    del program, params0
    free(device)

    t = time.perf_counter()
    nums = judge(cell, seed, device, checked)
    del checked
    ok, checks = compare_mod.check(nums, cell.workload["limits"])
    log(f"reference: {time.perf_counter() - t:.3f} s; numbers "
        + json.dumps(nums))
    return {"record": record, "correct": ok and failed == 0,
            "checks": checks, "numbers": nums, "attempted": rounds,
            "failed": failed, "memory_peak_bytes": peak}


def launch_counts(cell: Cell) -> Dict[str, int]:
    out = {}
    for k in cell.workload.get("kernels", []):
        op = getattr(importlib.import_module(f"repro_torch.kernels.{k}.ops"),
                     k)
        out[k] = op.launches
    return out


def read_metrics(cell: Cell, record: dict, traced: bool) -> Dict[str, dict]:
    out = {}
    for m in cell.metrics(traced):
        value = cell.reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(args, root: str, t_start: float) -> int:
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    cell = Cell(root, args.workload)
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"the cell asks for {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.init()
    out = run(cell, args.seed, args.seconds, bool(args.trace), device,
              t_start)
    record = out["record"]
    print(f"card: {power_limit()}; peaks "
          + json.dumps({**peaks.PEAK_FLOPS, "hbm": peaks.HBM_BYTES_PER_S}))
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark forbids: {found}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": read_metrics(cell, record, bool(args.trace)),
              "device": dev}
    if args.trace:
        tr = record["trace"] or {}
        dev["busy_s"] = tr.get("busy_s", 0.0)
        dev["window_s"] = tr.get("window_s", 0.0)
        if tr:
            result["breakdown"] = tr["breakdown"]
            print("spans: " + json.dumps(tr["spans"]))
        if record["steps"]:
            print("steps_ms: " + json.dumps(record["steps"]))
    print(f"memory: peak allocated {out['memory_peak_bytes']} B, "
          f"reserved {torch.cuda.max_memory_reserved()} B")
    result["checks"] = out["checks"]
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
