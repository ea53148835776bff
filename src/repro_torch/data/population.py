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

:class:`SyntheticPopulation` holds nothing per client. Row r of client
``i``'s shard in stream s (``TRAIN_STREAM``, its tester rows
``TEST_STREAM``) is Philox-4x32-10 under the population's key
(``philox_key(seed, SHARD_STREAM)``) at counters that name the lane,
the client and the row (:func:`draw_shards`): its label is one word of
counter ``(0, 2s + LABEL_LANE, i, r)`` mapped to ``[0, num_classes)``
by ``(w * num_classes) >> 32``, its image the label's class prototype
plus ``noise`` times the normals of counters ``(q, 2s + IMAGE_LANE, i,
r)``. A gather draws every id's rows in one pass on the ids' device,
with no generator and no read to the host, so a shard is a pure
function of ``(seed, stream, i)`` whichever cohort or slot gathers it,
a row does not depend on how many rows are drawn, and the population
round's chunk captures the gather in its CUDA graph. The global and
server eval sets are clients 0 and 1 of ``GLOBAL_STREAM``; only the
class prototypes come from a generator (``PROTO_STREAM``), once, at
build time. Nothing of size ``[N, ...image]`` ever exists. The port
does not draw threefry, so its values are its own, not the
reference's; they are not those of the port's earlier per-client
generators either, which read the ids to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.data.pipeline import FederatedDataset
from repro_torch.utils.seeding import (
    box_muller, derived_seed, padded_quads, philox4x32, philox_key)

# disjoint streams of a population's draws: the first three name a
# shard's counters, PROTO_STREAM seeds the prototypes' generator and
# SHARD_STREAM derives the shards' Philox key from the seed
TRAIN_STREAM = 0
TEST_STREAM = 1
GLOBAL_STREAM = 2
PROTO_STREAM = 3
SHARD_STREAM = 4
# a counter's second word is 2 * stream + lane
LABEL_LANE, IMAGE_LANE = 0, 1
# the most image elements one Philox pass draws
SHARD_SLICE = 1 << 24


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


def draw_shards(philox, protos: torch.Tensor, noise: float, stream: int,
                clients: torch.Tensor, rows: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``0..rows`` of each of ``clients`` (``[K]``, any integer
    dtype, on the device that draws) in ``stream`` under the Philox key
    words ``philox`` (one key for every block and stream: the counters
    tell them apart): images ``[K, rows, *protos.shape[1:]]`` f32 and labels
    ``[K, rows]`` int32. Each row's image quads and its label's quad are
    one Philox pass (a ``[rows, quads + 1]`` counter grid); a gather of
    more than ``SHARD_SLICE`` image elements goes in blocks of whole
    rows."""
    dev = clients.device
    shape = tuple(protos.shape[1:])
    d, classes = math.prod(shape), protos.shape[0]
    quads = padded_quads(d)
    # a row's counters: its image's quads 0..quads, then its label's 0
    q = torch.arange(quads + 1, dtype=torch.int64, device=dev)
    image = q < quads
    c0 = torch.where(image, q, 0)[None]
    c1 = torch.where(image, 2 * stream + IMAGE_LANE,
                     2 * stream + LABEL_LANE)[None]
    k = clients.shape[0]
    who = clients.long()[:, None].expand(k, rows).reshape(-1, 1)
    row = torch.arange(rows, dtype=torch.int64,
                       device=dev)[None].expand(k, rows).reshape(-1, 1)
    per = max(1, SHARD_SLICE // d)
    xs, ys = [], []
    for r0 in range(0, k * rows, per):
        x = philox4x32((c0, c1, who[r0:r0 + per], row[r0:r0 + per]),
                       philox)
        labels = (x[0][:, quads] * classes) >> 32
        z = box_muller([w[:, :quads] for w in x])[:, :d]
        xs.append(protos[labels] + noise * z.reshape((-1,) + shape))
        ys.append(labels.to(torch.int32))
    imgs = xs[0] if len(xs) == 1 else torch.cat(xs)
    labels = ys[0] if len(ys) == 1 else torch.cat(ys)
    return (imgs.reshape((k, rows) + shape), labels.reshape(k, rows))


@dataclasses.dataclass
class SyntheticPopulation:
    """Derive-on-gather population: a shard exists only while sampled."""

    philox: Tuple[int, int]          # the shards' Philox key words
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

    def cohort_train(self, idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return draw_shards(self.philox, self.protos, self.noise, TRAIN_STREAM,
                           idx, self.per_client)

    def tester_batches(self, tester_ids: torch.Tensor, eval_batch: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        return draw_shards(self.philox, self.protos, self.noise, TEST_STREAM,
                           tester_ids, eval_batch)

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
    philox = philox_key(seed, SHARD_STREAM)
    gx, gy = (t[0] for t in draw_shards(
        philox, protos, noise, GLOBAL_STREAM,
        torch.zeros((1,), dtype=torch.int64, device=dev), global_test))
    sx, sy = (t[0] for t in draw_shards(
        philox, protos, noise, GLOBAL_STREAM,
        torch.ones((1,), dtype=torch.int64, device=dev), server))
    return SyntheticPopulation(
        philox=philox, protos=protos, global_x=gx, global_y=gy, server_x=sx,
        server_y=sy, num_clients=num_clients, per_client=per_client,
        noise=noise)
