"""Single-device driver of the round engine (counterpart of
``repro/core/engine/driver.py``).

:class:`FederatedTrainer` drives :class:`RoundProgram` on the
:class:`LocalBackend`, one eager round per :meth:`run_round`. It runs on
the card unless the caller passes ``device="cpu"``; asked for the card
where there is none, it raises rather than carrying on on the CPU.
``PopulationTrainer`` (``core/engine/population.py``) subclasses it for
cohort rounds through :meth:`FederatedTrainer._make_backend`. The
scanned multi-round driver (``rounds_per_call``, ROADMAP.md queue 1 item
8) is not ported.

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

from repro_torch.checkpoint import LeafSpec, check_manifest, run_manifest
from repro_torch.checkpoint.serialization import conform, flatten_with_paths
from repro_torch.config import FedConfig, TrainConfig
from repro_torch.core.cross_testing import (
    eval_batch_indices, gather_eval_batches)
from repro_torch.core.engine.backends import LocalBackend
from repro_torch.core.engine.program import (
    RoundDraws, RoundProgram, init_comp_state)
from repro_torch.core.scoring import ScoreState, init_scores
from repro_torch.data.pipeline import FederatedDataset, gather_client_batches
from repro_torch.utils import tree_map


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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.program = RoundProgram(self.model, self.fed, self.train)
        self.backend = self._make_backend(
            self.crosstest_impl or self.fed.crosstest_impl)
        self.opt = self.program.opt
        self.aggregator = self.program.aggregator
        self.attack = self.program.attack
        self.selector = self.program.selector

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

    def run_round(self, state: RoundState, data: FederatedDataset,
                  draws: Optional[RoundDraws] = None):
        """One round; ``draws`` replaces the round's own draws (the parity
        tests replay the reference's)."""
        if draws is None:
            draws = self.draw(state, data)
        bx, by = gather_client_batches(data.train, draws.batch_idx)
        tx, ty = self.eval_batches(data, draws)
        new_global, new_scores, new_comp, metrics = self.program.run(
            self.backend, state.global_params, state.scores,
            bx=bx, by=by, tx=tx, ty=ty, draws=draws,
            round_idx=state.round_idx, counts=data.train.counts,
            server_data=(data.server_x[:self.eval_batch],
                         data.server_y[:self.eval_batch]),
            comp_state=state.comp_state)
        return state._replace(global_params=new_global, scores=new_scores,
                              round_idx=state.round_idx + 1,
                              comp_state=new_comp), metrics

    def global_accuracy(self, state: RoundState, data: FederatedDataset
                        ) -> float:
        """Accuracy of the global model on the first 2048 global samples,
        as the reference measures it."""
        return float(self.program.eval_fn(state.global_params,
                                          data.global_x[:2048],
                                          data.global_y[:2048]))

    def run(self, data: FederatedDataset, rounds: Optional[int] = None,
            eval_every: int = 1, verbose: bool = False,
            state: Optional[RoundState] = None, ckpt=None,
            should_stop: Optional[Callable[[], bool]] = None):
        """Rounds up to ``rounds`` (default ``fed.rounds``), the global
        accuracy read every ``eval_every`` rounds and after the last;
        returns (final_state, history dict).

        ``state`` resumes a run (from :meth:`restore_checkpoint`):
        ``rounds`` is the total, so a state at round k runs rounds k to
        ``rounds``, bitwise as an unbroken run would. ``ckpt``, a
        ``CheckpointManager``, saves at its ``save_every`` cadence;
        ``should_stop()`` is asked
        before each round, so a signal handler ends the loop at a round
        boundary and the caller saves the returned state."""
        rounds = self.fed.rounds if rounds is None else rounds
        if state is None:
            state = self.init()
        history = {"round": [], "global_accuracy": [], "local_loss": [],
                   "malicious_weight": []}
        while state.round_idx < rounds:
            if should_stop is not None and should_stop():
                break
            state, metrics = self.run_round(state, data)
            done = state.round_idx
            if ckpt is not None and ckpt.should_save(done):
                self.save_checkpoint(ckpt, state)
            if done % eval_every and done < rounds:
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
