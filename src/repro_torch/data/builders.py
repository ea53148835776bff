"""One-call builder assembling a FederatedDataset on a device."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.data.partition import (
    build_client_arrays, dirichlet_partition, paper_noniid_partition)
from repro_torch.data.pipeline import FederatedDataset, split_client_holdout
from repro_torch.data.synthetic import ImageSpec, make_image_dataset


def make_federated_image_dataset(spec: ImageSpec, num_users: int,
                                 num_samples: int = 20_000,
                                 partition: str = "paper",
                                 partition_kwargs: Optional[dict] = None,
                                 holdout_frac: float = 0.2,
                                 server_frac: float = 0.1,
                                 global_test: int = 2_000,
                                 seed: int = 0,
                                 device="cuda") -> FederatedDataset:
    """The reference's builder; the arrays are made in numpy exactly as
    there and moved to ``device`` once. ``partition_kwargs`` go to the
    partitioner (e.g. ``{"min_classes": 8}``)."""
    x, y = make_image_dataset(spec, num_samples + global_test, seed=seed)
    gx, gy = x[num_samples:], y[num_samples:]
    x, y = x[:num_samples], y[:num_samples]

    # the server's held-out set for the accuracy-based baseline
    n_server = int(num_samples * server_frac)
    sx, sy = x[:n_server], y[:n_server]
    x, y = x[n_server:], y[n_server:]

    pkw = dict(partition_kwargs or {})
    if partition == "paper":
        parts = paper_noniid_partition(y, num_users, seed=seed + 1, **pkw)
    elif partition == "dirichlet":
        parts = dirichlet_partition(y, num_users, seed=seed + 1, **pkw)
    elif partition == "iid":
        idx = np.random.default_rng(seed + 1).permutation(len(y))
        parts = np.array_split(idx, num_users)
    else:
        raise ValueError(partition)

    xs, ys, counts = build_client_arrays(x, y, parts)
    train, test = split_client_holdout(xs, ys, counts, frac=holdout_frac,
                                       device=device)
    return FederatedDataset(
        train=train, test=test,
        global_x=torch.as_tensor(gx, device=device),
        global_y=torch.as_tensor(gy, device=device),
        server_x=torch.as_tensor(sx, device=device),
        server_y=torch.as_tensor(sy, device=device))
