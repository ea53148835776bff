"""Single-device driver of the round engine (counterpart of
``repro/core/engine/driver.py``).

:class:`FederatedTrainer` drives :class:`RoundProgram` on the
:class:`LocalBackend`, one eager round per :meth:`run_round`. It runs on
the card unless the caller passes ``device="cpu"``; asked for the card
where there is none, it raises rather than carrying on on the CPU.
``PopulationTrainer`` (``core/engine/population.py``) subclasses it for
cohort rounds through :meth:`FederatedTrainer._make_backend`.

The multi-round driver (``rounds_per_call`` = R > 1, the twin of the
reference's ``lax.scan`` over R rounds): :meth:`~FederatedTrainer.run`
sends every full chunk of R rounds through
:meth:`~FederatedTrainer.run_chunk` and a remainder through
:meth:`~FederatedTrainer.run_round`. A chunk plays its rounds on static
buffers (the global params, the ``ScoreState``, the error feedback, a
generator and the round index as a 0-d device counter), each round
writing its results back into them, with no read to the host between
rounds. On the card the round is one ``torch.cuda.CUDAGraph``, captured
once a trainer after an eager warm-up round on a side stream (whose
draws and results are undone) and replayed R times; the run's generator
is registered with the graph, so R replays leave it where R eager rounds
do. A failed capture raises: there is no eager fallback on ``cuda``. On
the CPU the same round runs R times in a loop. Either way the states,
the generator and the history are those of R single rounds, bitwise.
The host prepares what the graph reads before a chunk (the ``coverage``
selector's permutations, :meth:`Selector.schedule`; the population tier's
noise key of the seed, ``_load_seed``) and before a replay whose eval
bucket is new (its eval rows). The population tier plays its own round
body (``PopulationTrainer._chunk_round``) on the same buffers. A kernel
op's ``launches`` count sees the capture's one call, not the replays.

Durability (DESIGN.md §9): :meth:`FederatedTrainer.state_dict` copies a
round state to host arrays, the generator's ``get_state()`` bytes
included, and :meth:`~FederatedTrainer.load_state` rebuilds it; a
checkpoint (``repro_torch.checkpoint``) holds that tree with the run
manifest, and a run resumed from it draws the stream an unbroken run
draws, so it is bitwise the same run. Nothing is drawn at build time.

Each round's tester eval rows are every client's first ``eval_batch``
test rows, or, with ``eval_resample_every`` = r > 0, rows drawn anew
every r rounds from the run's seed and the round's bucket alone
(``cross_testing.eval_batch_indices``): a pure function of the two, so
the round's own generator is untouched and the draws of path A stay as
they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.checkpoint import LeafSpec, check_manifest, run_manifest
from repro_torch.checkpoint.serialization import conform, flatten_with_paths
from repro_torch.config import FedConfig, TrainConfig
from repro_torch.core.cross_testing import (
    eval_batch_indices, gather_eval_batches)
from repro_torch.core.engine.backends import LocalBackend, pod_backend
from repro_torch.core.engine.program import (
    RoundDraws, RoundProgram, init_comp_state)
from repro_torch.core.scoring import ScoreState, init_scores
from repro_torch.data.pipeline import FederatedDataset, gather_client_batches
from repro_torch.utils import tree_leaves, tree_map


def resolve_device(device) -> torch.device:
    """The run's device. Turns TF32 off for convolutions and matmuls, so
    fp32 models run in full fp32 on the card, as the reference runs them.
    Makes cuDNN deterministic and stops it from benchmarking algorithms:
    its default conv backward sums with atomics in an order that changes
    from run to run, and the reference's rule is that a run from one seed
    is bit-identical (DESIGN.md §9). Raises when the card is asked for
    and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev


class RoundState(NamedTuple):
    global_params: Any
    scores: ScoreState
    round_idx: int
    gen: torch.Generator            # the run's randomness, on the device
    # [N, D] error-feedback buffer of the compressed exchange; None when
    # the exchange is uncompressed
    comp_state: Optional[torch.Tensor] = None
    seed: int = 0                   # the run's seed (eval-batch draws)


class StateDict(NamedTuple):
    """A :class:`RoundState` as host (numpy) arrays: the tree a checkpoint
    holds, bf16 leaves as f32. Its path strings are the reference's
    (``.global_params/conv0/b``, ``.scores/.tester_trust``,
    ``.round_idx``); ``.gen_state`` (the generator's ``get_state()``
    bytes) and ``.seed`` are the port's own."""

    global_params: Any
    scores: ScoreState
    round_idx: Any                  # 0-d int32
    gen_state: Any                  # [bytes] uint8
    comp_state: Any = None          # [N, D] f32, or None uncompressed
    seed: Any = None                # 0-d int64


@dataclasses.dataclass
class ChunkBuffers:
    """The static tensors a chunk's round reads and writes in place, and
    on the card its graph: allocated by the first chunk of a trainer and
    reused by every later one."""

    params: Any                     # the global params tree
    scores: ScoreState
    comp: Optional[torch.Tensor]    # the error feedback, or None
    counter: torch.Tensor           # 0-d int64: the round index
    gen: torch.Generator            # the graph's registered generator
    data: Any                       # the dataset the round reads
    seed: int = 0
    eval_idx: Optional[torch.Tensor] = None  # [N, eval_batch] int64
    bucket: Any = None              # the (seed, eval bucket) eval_idx holds
    graph: Any = None               # torch.cuda.CUDAGraph on the card
    metrics: Any = None             # the captured round's metric outputs
    # the captured round's spans (tracing.graph_spans); empty when the
    # capture ran with tracing off
    spans: Any = ()
    # [2] int64: the population tier's noise key of the seed
    key: Optional[torch.Tensor] = None

    def tensors(self):
        """The static round state (params, scores, error feedback) in
        :func:`_flat_state`'s order."""
        return _flat_state(self.params, self.scores, self.comp)


def _flat_state(global_params, scores, comp_state):
    """A round state's tensors in one fixed order."""
    out = tree_leaves(global_params) + list(scores)
    return out + ([] if comp_state is None else [comp_state])


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's copy in host memory, bf16 as f32 (numpy has no bf16)."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


@dataclasses.dataclass
class FederatedTrainer:
    model: Any                      # repro_torch.models.Model
    fed: FedConfig
    train: TrainConfig
    eval_batch: int = 256
    device: Any = "cuda"
    crosstest_impl: Optional[str] = None  # None -> fed.crosstest_impl
    # 0 keeps the fixed eval prefix (the first eval_batch test rows, every
    # round); r > 0 redraws each tester's eval rows every r rounds
    eval_resample_every: int = 0
    # > 1 sends run()'s full chunks of this many rounds through run_chunk
    # (one CUDA graph of a round, replayed, on the card)
    rounds_per_call: int = 1

    def __post_init__(self):
        if self.rounds_per_call < 1:
            raise ValueError(f"rounds_per_call must be >= 1, got "
                             f"{self.rounds_per_call}")
        self.device = resolve_device(self.device)
        self.program = RoundProgram(self.model, self.fed, self.train)
        self.backend = self._make_backend(
            self.crosstest_impl or self.fed.crosstest_impl)
        self.opt = self.program.opt
        self.aggregator = self.program.aggregator
        self.attack = self.program.attack
        self.selector = self.program.selector
        # the chunk's static buffers and graph: made by the first chunk,
        # one capture a trainer
        self.chunk: Optional[ChunkBuffers] = None

    def _make_backend(self, impl: str):
        """The backend factory hook; the population tier overrides it."""
        return LocalBackend(self.fed.num_users, impl)

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> RoundState:
        """Fresh params and scores; ``seed`` (default ``fed.seed``) seeds
        the generator every later draw of the run comes from."""
        seed = self.fed.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return RoundState(global_params=self.model.init(gen),
                          scores=init_scores(self.fed.num_users,
                                             self.device),
                          round_idx=0, gen=gen,
                          comp_state=init_comp_state(self.fed, self.model,
                                                     self.device),
                          seed=seed)

    # ------------------------------------------------------------ durability
    def manifest(self) -> dict:
        """The run's resume fingerprint, stored beside its checkpoints."""
        return run_manifest(self.model.cfg, self.fed, self.train)

    def state_template(self) -> StateDict:
        """The shapes and dtypes of this run's :class:`StateDict`; builds
        no params and draws nothing."""
        n = self.fed.num_users
        gen_bytes = torch.Generator(device=self.device).get_state().numel()
        return StateDict(
            global_params=tree_map(lambda s: LeafSpec(tuple(s), np.float32),
                                   self.model.param_shapes()),
            scores=ScoreState(LeafSpec((n,), np.float32),
                              LeafSpec((), np.int32),
                              LeafSpec((n,), np.float32)),
            round_idx=LeafSpec((), np.int32),
            gen_state=LeafSpec((gen_bytes,), np.uint8),
            comp_state=(LeafSpec((n, self.program.compressor.dim),
                                 np.float32)
                        if self.program.use_compression else None),
            seed=LeafSpec((), np.int64))

    def state_dict(self, state: RoundState) -> StateDict:
        """A host copy of the whole round state: params, scores with
        tester trust, the round, the generator's state, the error
        feedback and the seed."""
        return StateDict(
            global_params=tree_map(_host, state.global_params),
            scores=ScoreState(*(_host(t) for t in state.scores)),
            round_idx=np.asarray(state.round_idx, np.int32),
            gen_state=state.gen.get_state().numpy(),
            comp_state=(None if state.comp_state is None
                        else _host(state.comp_state)),
            seed=np.asarray(state.seed, np.int64))

    def load_state(self, state_dict: StateDict) -> RoundState:
        """The :class:`RoundState` on this trainer's device, each leaf
        cast to the template's dtype (``rounds_seen`` int32) and then the
        model's; ``ValueError`` on a leaf count, path or shape that is not
        this run's. The generator resumes at the saved state."""
        sd = conform(self.state_template(), flatten_with_paths(state_dict))
        dev = self.device

        def put(a, dtype=None):
            return torch.tensor(a, device=dev, dtype=dtype)

        gen = torch.Generator(device=dev)
        gen.set_state(torch.from_numpy(np.ascontiguousarray(sd.gen_state)))
        return RoundState(
            global_params=tree_map(put, sd.global_params,
                                   self.model.param_dtypes()),
            scores=ScoreState(*(put(a) for a in sd.scores)),
            round_idx=int(sd.round_idx), gen=gen,
            comp_state=None if sd.comp_state is None else put(sd.comp_state),
            seed=int(sd.seed))

    def save_checkpoint(self, mgr, state: RoundState,
                        step: Optional[int] = None) -> str:
        """Write ``state`` atomically at its round (or ``step``); the
        run manifest goes beside the directory's first checkpoint, and
        another run's refuses the save."""
        step = state.round_idx if step is None else int(step)
        return mgr.save(step, self.state_dict(state),
                        manifest=self.manifest())

    def restore_checkpoint(self, mgr, step: Optional[int] = None):
        """``(state, step)`` from the newest loadable checkpoint (or
        ``step``), refusing another run's manifest before reading any
        array."""
        saved = mgr.read_manifest()
        if saved is not None:
            check_manifest(saved, self.manifest())
        state_dict, at = mgr.restore_with_step(self.state_template(), step)
        return self.load_state(state_dict), at

    # ------------------------------------------------------------------- API
    def draw(self, state: RoundState, data: FederatedDataset
             ) -> RoundDraws:
        """The round's draws: the program's from ``state.gen``, plus the
        eval rows of the round's bucket under eval resampling."""
        with tracing.span("draw"):
            draws = self.program.draw_round(
                state.gen, data.train.counts, state.round_idx,
                state.global_params, scores=state.scores.scores)
            if self.eval_resample_every > 0:
                draws = draws._replace(eval_idx=eval_batch_indices(
                    state.seed, data.test.counts, self.eval_batch,
                    state.round_idx // self.eval_resample_every))
        return draws

    def eval_batches(self, data: FederatedDataset, draws: RoundDraws):
        """Every client's tester eval batch ``[N, eval_batch, ...]``: the
        rows ``draws.eval_idx`` names, else the fixed prefix."""
        if draws.eval_idx is None:
            return (data.test.xs[:, :self.eval_batch],
                    data.test.ys[:, :self.eval_batch])
        return gather_eval_batches(data.test.xs, data.test.ys,
                                   draws.eval_idx)

    def client_batches(self, data: FederatedDataset, draws: RoundDraws):
        """The training batches and tester eval rows of the clients this
        trainer plays: every client's, ``[N, steps, batch, ...]`` and
        ``[N, eval_batch, ...]``."""
        with tracing.span("batches"):
            bx, by = gather_client_batches(data.train, draws.batch_idx)
            return (bx, by) + self.eval_batches(data, draws)

    def _play(self, global_params, scores, comp_state, round_idx, data,
              draws: RoundDraws):
        """Steps 1-7 on the round's draws; ``round_idx`` is the host int
        or the chunk's device counter."""
        bx, by, tx, ty = self.client_batches(data, draws)
        return self.program.run(
            self.backend, global_params, scores,
            bx=bx, by=by, tx=tx, ty=ty, draws=draws,
            round_idx=round_idx, counts=data.train.counts,
            server_data=(data.server_x[:self.eval_batch],
                         data.server_y[:self.eval_batch]),
            comp_state=comp_state)

    def run_round(self, state: RoundState, data: FederatedDataset,
                  draws: Optional[RoundDraws] = None):
        """One round; ``draws`` replaces the round's own draws (the parity
        tests replay the reference's)."""
        with tracing.span("round", state.round_idx):
            if draws is None:
                draws = self.draw(state, data)
            new_global, new_scores, new_comp, metrics = self._play(
                state.global_params, state.scores, state.comp_state,
                state.round_idx, data, draws)
        return state._replace(global_params=new_global, scores=new_scores,
                              round_idx=state.round_idx + 1,
                              comp_state=new_comp), metrics

    # ------------------------------------------------------ the chunk driver
    def _chunk_round(self, buf: ChunkBuffers):
        """One round on the static buffers, its results written back into
        them and the counter advanced: the body a chunk captures."""
        draws = self.program.draw_round(
            buf.gen, buf.data.train.counts, buf.counter, buf.params,
            scores=buf.scores.scores)
        if self.eval_resample_every > 0:
            draws = draws._replace(eval_idx=buf.eval_idx)
        new_global, new_scores, new_comp, metrics = self._play(
            buf.params, buf.scores, buf.comp, buf.counter, buf.data, draws)
        for dst, src in zip(buf.tensors(),
                            _flat_state(new_global, new_scores, new_comp)):
            dst.copy_(src)
        buf.counter.add_(1)
        return metrics

    def _load_chunk(self, state: RoundState, data) -> ChunkBuffers:
        """Copy ``state`` into the static buffers, the host's round index
        into the counter and its generator state into the buffers' own,
        and let the selector load the chunk's schedule. The first chunk of
        a trainer allocates the buffers and captures the round (a graph
        on the card); every later chunk replays that capture, so one on
        another dataset, which would need a second, raises."""
        buf = self.chunk
        if buf is not None and data is not buf.data:
            raise ValueError("a chunk's round reads the dataset it was "
                             "captured on; build a trainer for another")
        if buf is None:
            buf = ChunkBuffers(
                params=tree_map(torch.clone, state.global_params),
                scores=ScoreState(*(t.clone() for t in state.scores)),
                comp=(None if state.comp_state is None
                      else state.comp_state.clone()),
                counter=torch.zeros((), dtype=torch.int64,
                                    device=self.device),
                gen=torch.Generator(device=self.device), data=data)
        else:
            for dst, src in zip(buf.tensors(), _flat_state(
                    state.global_params, state.scores, state.comp_state)):
                dst.copy_(src)
        buf.counter.fill_(state.round_idx)
        buf.gen.set_state(state.gen.get_state())
        buf.seed = state.seed
        self._load_seed(buf)
        self.selector.schedule(state.round_idx, self.rounds_per_call,
                               self.fed.num_users, self.fed.num_testers,
                               self.device)
        self._load_eval_rows(buf, state.round_idx)
        if self.chunk is None:
            if self.device.type == "cuda":
                self._capture(buf)
            self.chunk = buf
        return buf

    def _load_seed(self, buf: ChunkBuffers) -> None:
        """Load what the round derives from ``buf.seed`` into the buffers
        (the population tier's noise key); nothing on the dense
        engine."""

    def _load_eval_rows(self, buf: ChunkBuffers, round_idx: int) -> None:
        """Under eval resampling, write the eval rows of ``round_idx``'s
        bucket into the static buffer the round gathers from, when the
        (seed, bucket) is not the one it holds. Drawn from (seed, bucket)
        alone, outside the round's stream."""
        if self.eval_resample_every <= 0:
            return
        bucket = (buf.seed, round_idx // self.eval_resample_every)
        if bucket == buf.bucket:
            return
        idx = eval_batch_indices(buf.seed, buf.data.test.counts,
                                 self.eval_batch, bucket[1])
        if buf.eval_idx is None:
            buf.eval_idx = idx
        else:
            buf.eval_idx.copy_(idx)
        buf.bucket = bucket

    def _capture(self, buf: ChunkBuffers) -> None:
        """Capture one round on the static buffers into a CUDA graph. An
        eager warm-up round on a side stream first makes every lazy
        first-call set-up (library loads, cuBLAS handles, kernel
        attributes) outside the capture; its results and draws are then
        undone. The buffers' generator is registered with the graph, so
        each replay draws on from where the generator stands. With tracing
        on, the round's spans become event nodes of the graph
        (``buf.spans``)."""
        saved = [t.clone() for t in buf.tensors()]
        counter, gen_state = buf.counter.clone(), buf.gen.get_state()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._chunk_round(buf)
        main.wait_stream(side)
        for dst, src in zip(buf.tensors() + [buf.counter],
                            saved + [counter]):
            dst.copy_(src)
        buf.gen.set_state(gen_state)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(buf.gen)
        with tracing.graph_spans() as spans, torch.cuda.graph(graph):
            buf.metrics = self._chunk_round(buf)
        buf.graph, buf.spans = graph, spans

    def run_chunk(self, state: RoundState, data: FederatedDataset):
        """``rounds_per_call`` rounds with no read to the host between
        them: on the card ``rounds_per_call`` replays of the trainer's
        one graph of a round, on the CPU the same round in a loop.
        Returns ``(state, metrics)``, each metric stacked ``[R, ...]``;
        the state and the generator are those of R :meth:`run_round`
        calls, bitwise. With tracing on, the spans of the chunk's last
        replay are queued, and read at the next chunk or export once the
        caller's own host read has waited for them."""
        # the previous chunk's last replay, before this one overwrites it
        tracing.settle()
        with tracing.span("chunk", state.round_idx):
            captures = self.chunk is None and self.device.type == "cuda"
            with tracing.span("capture" if captures else "load"):
                buf = self._load_chunk(state, data)
            rounds = []
            for i in range(self.rounds_per_call):
                self._load_eval_rows(buf, state.round_idx + i)
                if buf.graph is not None:
                    with tracing.span("replay", state.round_idx + i):
                        buf.graph.replay()
                        if i == self.rounds_per_call - 1:
                            tracing.replayed(buf.spans)
                    metrics = buf.metrics
                else:
                    with tracing.span("round", state.round_idx + i):
                        metrics = self._chunk_round(buf)
                # the graph's outputs (and a metric that is a static
                # buffer) are overwritten by the next round
                rounds.append({k: v.clone() for k, v in metrics.items()})
        state.gen.set_state(buf.gen.get_state())
        stacked = {k: torch.stack([m[k] for m in rounds]) for k in rounds[0]}
        return state._replace(
            global_params=tree_map(torch.clone, buf.params),
            scores=ScoreState(*(t.clone() for t in buf.scores)),
            round_idx=state.round_idx + self.rounds_per_call,
            comp_state=None if buf.comp is None else buf.comp.clone()
        ), stacked

    def global_accuracy(self, state: RoundState, data: FederatedDataset
                        ) -> float:
        """Accuracy of the global model on the first 2048 global samples,
        as the reference measures it."""
        with tracing.span("global_eval", state.round_idx):
            return float(self.program.eval_fn(state.global_params,
                                              data.global_x[:2048],
                                              data.global_y[:2048]))

    def run(self, data: FederatedDataset, rounds: Optional[int] = None,
            eval_every: int = 1, verbose: bool = False,
            state: Optional[RoundState] = None, ckpt=None,
            should_stop: Optional[Callable[[], bool]] = None):
        """Rounds up to ``rounds`` (default ``fed.rounds``), the global
        accuracy read every ``eval_every`` rounds, after the last and at
        every chunk boundary; returns (final_state, history dict).

        With ``rounds_per_call`` = R > 1 every full chunk of R rounds
        goes through :meth:`run_chunk` and a remainder of ``rounds % R``
        through :meth:`run_round`; the history keeps a chunk's last
        round's loss and malicious weight. ``state`` resumes a run (from
        :meth:`restore_checkpoint`): ``rounds`` is the total, so a state
        at round k runs rounds k to ``rounds``, bitwise as an unbroken
        run would, through either driver. ``ckpt``, a
        ``CheckpointManager``, saves at its ``save_every`` cadence
        between driver calls; ``should_stop()`` is asked before each
        call, so a signal handler ends the loop at a round or chunk
        boundary and the caller saves the returned state."""
        rounds = self.fed.rounds if rounds is None else rounds
        if state is None:
            state = self.init()
        history = {"round": [], "global_accuracy": [], "local_loss": [],
                   "malicious_weight": []}
        while state.round_idx < rounds:
            if should_stop is not None and should_stop():
                break
            step = self.rounds_per_call
            if step > 1 and rounds - state.round_idx >= step:
                state, chunk = self.run_chunk(state, data)
                metrics = {k: v[-1] for k, v in chunk.items()}
            else:
                state, metrics = self.run_round(state, data)
                step = 1
            done = state.round_idx
            if ckpt is not None and ckpt.should_save(done):
                self.save_checkpoint(ckpt, state)
            if done % eval_every and done < rounds and step == 1:
                continue
            ga = self.global_accuracy(state, data)
            history["round"].append(done)
            history["global_accuracy"].append(ga)
            history["local_loss"].append(float(metrics["local_loss"]))
            history["malicious_weight"].append(
                float(metrics["malicious_weight"]))
            if verbose:
                print(f"round {done:4d}  acc={ga:.4f}  "
                      f"loss={float(metrics['local_loss']):.4f}  "
                      f"mal_w={float(metrics['malicious_weight']):.4f}")
        return state, history


@dataclasses.dataclass
class PodTrainer(FederatedTrainer):
    """One rank's driver of the pod round: client ``group.rank`` of a
    ``torch.distributed`` group of ``fed.num_users`` ranks, on
    ``group.device`` (:class:`~repro_torch.launch.mesh.RankGroup`).

    Every rank holds the whole replicated state (params, scores, error
    feedback) and the same generator, seeded as the local driver seeds
    it, so each draws the whole round's stream and keeps its own row: the
    pod sees the draws the local round sees. A round trains, attacks and
    encodes the rank's own client and exchanges the rest through the
    ``exchange`` backend (``ring`` or ``allgather``). Rank 0 writes a
    checkpoint and every rank restores it, so a resumed run is bitwise the
    unbroken one. One round a call: a chunk of rounds
    (``rounds_per_call`` > 1) is refused."""

    group: Any = None
    exchange: str = "ring"

    def __post_init__(self):
        if self.rounds_per_call > 1:
            raise ValueError("the pod round runs one round a call; "
                             "rounds_per_call > 1 runs on the dense engine")
        self.device = self.group.device
        super().__post_init__()

    def _make_backend(self, impl: str):
        return pod_backend(self.fed, self.group, self.exchange, impl)

    def client_batches(self, data: FederatedDataset, draws: RoundDraws):
        """The rank's own client's rows: ``[steps, batch, ...]`` and
        ``[eval_batch, ...]``."""
        r = self.group.rank
        idx = draws.batch_idx[r]
        tx, ty = self.eval_batches(data, draws)
        return data.train.xs[r][idx], data.train.ys[r][idx], tx[r], ty[r]

    def save_checkpoint(self, mgr, state: RoundState,
                        step: Optional[int] = None) -> Optional[str]:
        """Rank 0 writes ``state`` (replicated on every rank); the others
        wait for it. Returns the path on rank 0."""
        path = (super().save_checkpoint(mgr, state, step)
                if self.group.rank == 0 else None)
        self.group.barrier()
        return path
