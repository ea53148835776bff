"""Single-device driver of the round engine (counterpart of
``repro/core/engine/driver.py``).

:class:`FederatedTrainer` drives :class:`RoundProgram` on the
:class:`LocalBackend`, one eager round per :meth:`run_round`. It runs on
the card unless the caller passes ``device="cpu"``; asked for the card
where there is none, it raises rather than carrying on on the CPU.
Checkpointing (ROADMAP.md queue 1 item 10) and the scanned multi-round
driver (``rounds_per_call``, item 8) are not ported.

Each round's tester eval rows are every client's first ``eval_batch``
test rows, or, with ``eval_resample_every`` = r > 0, rows drawn anew
every r rounds from the run's seed and the round's bucket alone
(``cross_testing.eval_batch_indices``): a pure function of the two, so
the round's own generator is untouched and the draws of path A stay as
they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.config import FedConfig, TrainConfig
from repro_torch.core.cross_testing import (
    eval_batch_indices, gather_eval_batches)
from repro_torch.core.engine.backends import LocalBackend
from repro_torch.core.engine.program import (
    RoundDraws, RoundProgram, init_comp_state)
from repro_torch.core.scoring import ScoreState, init_scores
from repro_torch.data.pipeline import FederatedDataset, gather_client_batches


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
        self.backend = LocalBackend(
            self.fed.num_users, self.crosstest_impl or self.fed.crosstest_impl)
        self.opt = self.program.opt
        self.aggregator = self.program.aggregator
        self.attack = self.program.attack
        self.selector = self.program.selector

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

    def run(self, data: FederatedDataset, verbose: bool = False):
        """``fed.rounds`` rounds from a fresh state, evaluated after each;
        returns (final_state, history dict)."""
        state = self.init()
        history = {"round": [], "global_accuracy": [], "local_loss": [],
                   "malicious_weight": []}
        while state.round_idx < self.fed.rounds:
            state, metrics = self.run_round(state, data)
            done = state.round_idx
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
