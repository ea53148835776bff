"""Population-scale data providers for the cohort engine (counterpart of
``repro/data/population.py``, DESIGN.md §11).

The dense :class:`~repro_torch.data.pipeline.FederatedDataset` holds
every client's shard as rows of one ``[N, M, ...]`` stack; the
population tier never reads more than the sampled cohort's rows. A
*population provider* exposes the gathers
:class:`~repro_torch.core.engine.population.PopulationTrainer` makes:

* ``train_counts``            — ``[N]`` per-client sample counts
* ``cohort_train(idx)``       — the cohort's ``[C, M, ...]`` train shards
* ``tester_batches(ids, b)``  — the K testers' ``[K, b, ...]`` eval rows
* ``server_batch(b)``         — the server's ``(sx, sy)`` eval slice
* ``global_x`` / ``global_y`` — the convergence-curve eval set

:class:`DensePopulationData` wraps a materialised dataset: its gathers
return, bitwise, the rows the dense driver reads, so a small population
run is held against ``FederatedTrainer``.

:class:`SyntheticPopulation` holds nothing per client: client ``i``'s
shard is drawn on gather from a generator seeded with
``derived_seed(seed, TRAIN_STREAM, i)`` (its tester rows from
``TEST_STREAM``) over shared class prototypes, so a shard is a pure
function of ``(seed, stream, i)``, whichever cohort gathers it, and
nothing of size ``[N, ...image]`` ever exists. The port does not draw
threefry, so its values are its own, not the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.data.pipeline import FederatedDataset
from repro_torch.utils import derived_seed

# disjoint stream constants deriving the per-client draws from the seed
TRAIN_STREAM = 0
TEST_STREAM = 1
GLOBAL_STREAM = 2
PROTO_STREAM = 3


@dataclasses.dataclass
class DensePopulationData:
    """Population view over a materialised :class:`FederatedDataset`."""

    dense: FederatedDataset

    @property
    def train_counts(self) -> torch.Tensor:
        return self.dense.train.counts

    @property
    def global_x(self) -> torch.Tensor:
        return self.dense.global_x

    @property
    def global_y(self) -> torch.Tensor:
        return self.dense.global_y

    def cohort_train(self, idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.dense.train.xs[idx], self.dense.train.ys[idx]

    def tester_batches(self, tester_ids: torch.Tensor, eval_batch: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = tester_ids.long()
        return (self.dense.test.xs[ids, :eval_batch],
                self.dense.test.ys[ids, :eval_batch])

    def server_batch(self, eval_batch: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.dense.server_x[:eval_batch],
                self.dense.server_y[:eval_batch])


def _draw_shard(protos: torch.Tensor, noise: float, seed: int, rows: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rows`` samples from a generator seeded with ``seed``: uniform
    labels, each image its class prototype plus ``noise`` times a
    standard normal."""
    dev = protos.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    labels = torch.randint(0, protos.shape[0], (rows,), generator=gen,
                           device=dev)
    imgs = protos[labels] + noise * torch.randn(
        (rows,) + protos.shape[1:], generator=gen, device=dev)
    return imgs, labels.to(torch.int32)


@dataclasses.dataclass
class SyntheticPopulation:
    """Derive-on-gather population: a shard exists only while sampled."""

    seed: int
    protos: torch.Tensor             # [num_classes, H, W, C] prototypes
    global_x: torch.Tensor
    global_y: torch.Tensor
    server_x: torch.Tensor
    server_y: torch.Tensor
    num_clients: int
    per_client: int
    noise: float

    @property
    def train_counts(self) -> torch.Tensor:
        return torch.full((self.num_clients,), self.per_client,
                          dtype=torch.int32, device=self.protos.device)

    def _shards(self, stream: int, ids: torch.Tensor, rows: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        xs, ys = zip(*(_draw_shard(self.protos, self.noise,
                                   derived_seed(self.seed, stream, i), rows)
                       for i in ids.tolist()))
        return torch.stack(xs), torch.stack(ys)

    def cohort_train(self, idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._shards(TRAIN_STREAM, idx, self.per_client)

    def tester_batches(self, tester_ids: torch.Tensor, eval_batch: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._shards(TEST_STREAM, tester_ids, eval_batch)

    def server_batch(self, eval_batch: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.server_x[:eval_batch], self.server_y[:eval_batch]


def make_synthetic_population(num_clients: int, *, per_client: int = 16,
                              image_size: int = 28, channels: int = 1,
                              num_classes: int = 10, noise: float = 0.45,
                              global_test: int = 256, server: int = 128,
                              seed: int = 0, device="cuda"
                              ) -> SyntheticPopulation:
    """A :class:`SyntheticPopulation` of ``num_clients`` clients on
    ``device``. Only the prototypes and the small global and server eval
    sets are drawn, so building it costs the same at any
    ``num_clients``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(
        derived_seed(seed, PROTO_STREAM))
    protos = torch.randn((num_classes, image_size, image_size, channels),
                         generator=gen, device=dev)
    gx, gy = _draw_shard(protos, noise, derived_seed(seed, GLOBAL_STREAM, 0),
                         global_test)
    sx, sy = _draw_shard(protos, noise, derived_seed(seed, GLOBAL_STREAM, 1),
                         server)
    return SyntheticPopulation(
        seed=seed, protos=protos, global_x=gx, global_y=gy, server_x=sx,
        server_y=sy, num_clients=num_clients, per_client=per_client,
        noise=noise)
