"""Federated data pipeline: client-stacked device tensors + batch gathers.

Local training runs vectorised across clients, so a round's batches are
one ``[N, local_steps, batch, ...]`` gather from the stacked client
tensors. The gather indices are one of the round's random draws
(:class:`~repro_torch.core.engine.program.RoundDraws`); this module only
draws them (:func:`sample_batch_indices`) and applies them
(:func:`gather_client_batches`). The population tier turns its gathered
rows of the same uniforms into indices with
:func:`batch_indices_from_uniforms`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ClientData:
    """Stacked per-client dataset. xs [N,M,...], ys [N,M] (int32)."""
    xs: torch.Tensor
    ys: torch.Tensor
    counts: torch.Tensor           # [N] valid rows per client (int32)

    @property
    def num_clients(self) -> int:
        return self.xs.shape[0]


@dataclasses.dataclass
class FederatedDataset:
    train: ClientData
    # held-out *local* eval shards (the FedTest testers' data)
    test: ClientData
    # global eval set (convergence curves) + server set (accuracy-based)
    global_x: torch.Tensor
    global_y: torch.Tensor
    server_x: torch.Tensor
    server_y: torch.Tensor


def sample_batch_indices(gen: torch.Generator, counts: torch.Tensor,
                         steps: int, batch: int) -> torch.Tensor:
    """Random-with-replacement row indices ``[N, steps, batch]`` (int64),
    the reference's formula ``int(u * count)`` on uniforms from ``gen``.
    The clamp keeps a float32 product that rounds up to ``count`` inside
    the client's valid rows."""
    n = counts.shape[0]
    u = torch.rand((n, steps, batch), generator=gen, device=counts.device)
    return batch_indices_from_uniforms(u, counts)


def batch_indices_from_uniforms(u: torch.Tensor, counts: torch.Tensor
                                ) -> torch.Tensor:
    """``u [R, steps, batch]`` uniforms and the ``[R]`` counts of their
    clients -> int64 row indices. Elementwise, so the rows of a cohort's
    gathered uniforms give the rows the whole draw would."""
    idx = (u * counts[:, None, None]).to(torch.int64)
    return torch.minimum(idx, (counts.to(torch.int64) - 1)[:, None, None])


def gather_client_batches(data: ClientData, idx: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``idx [N, steps, batch]`` -> (bx [N, steps, batch, ...], by)."""
    rows = torch.arange(data.num_clients, device=idx.device)[:, None, None]
    return data.xs[rows, idx], data.ys[rows, idx]


def split_client_holdout(xs: np.ndarray, ys: np.ndarray, counts: np.ndarray,
                         frac: float = 0.2, *, device
                         ) -> Tuple[ClientData, ClientData]:
    """Split stacked client arrays into train/test ClientData pairs,
    moved to ``device`` once."""
    N, M = xs.shape[0], xs.shape[1]
    n_test = np.maximum((counts * frac).astype(np.int32), 1)
    n_train = np.maximum(counts - n_test, 1)
    # test rows are the tail of each client's valid region
    test_x = np.zeros_like(xs)
    test_y = np.zeros_like(ys)
    for i in range(N):
        seg_x = xs[i, int(n_train[i]):int(counts[i])]
        seg_y = ys[i, int(n_train[i]):int(counts[i])]
        reps = int(np.ceil(M / max(len(seg_x), 1)))
        test_x[i] = np.tile(seg_x, (reps,) + (1,) * (xs.ndim - 2))[:M]
        test_y[i] = np.tile(seg_y, (reps,) + (1,) * (ys.ndim - 2))[:M]

    def dev(a):
        return torch.as_tensor(a, device=device)

    train = ClientData(dev(xs), dev(ys), dev(n_train.astype(np.int32)))
    test = ClientData(dev(test_x), dev(test_y), dev(n_test.astype(np.int32)))
    return train, test
