"""Non-IID client partitioners: a copy of ``repro/data/partition.py``
(plain numpy, so the port's shards are bitwise the reference's).

``paper_noniid_partition`` implements the paper's setup (Sec. III): each
user is randomly assigned a number of classes and a set of samples for
each class. ``dirichlet_partition`` is the Dir(alpha) partitioner.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def paper_noniid_partition(labels: np.ndarray, num_users: int,
                           min_classes: int = 2, max_classes: int = 6,
                           seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    for idx in by_class:
        rng.shuffle(idx)
    cursors = np.zeros(num_classes, dtype=int)

    user_classes = [list(rng.choice(num_classes,
                                    size=rng.integers(min_classes,
                                                      max_classes + 1),
                                    replace=False))
                    for _ in range(num_users)]
    # coverage guarantee: every class must have at least one holder
    for c in range(num_classes):
        if not any(c in ucs for ucs in user_classes):
            user_classes[int(rng.integers(num_users))].append(c)
    # per-class fair share among the users holding that class
    holders = {c: [u for u in range(num_users) if c in user_classes[u]]
               for c in range(num_classes)}
    parts: List[List[int]] = [[] for _ in range(num_users)]
    for c, us in holders.items():
        if not us:
            continue
        pool = by_class[c]
        share = len(pool) // len(us)
        for u in us:
            lo = cursors[c]
            # randomise each user's sample count around the fair share
            take = max(int(share * rng.uniform(0.4, 1.0)), 1)
            take = min(take, len(pool) - lo)
            parts[u].extend(pool[lo:lo + take])
            cursors[c] += take
    return [np.array(sorted(p), dtype=np.int64) for p in parts]


def dirichlet_partition(labels: np.ndarray, num_users: int,
                        alpha: float = 0.5, seed: int = 0
                        ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    parts: List[List[int]] = [[] for _ in range(num_users)]
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_users)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for u, chunk in enumerate(np.split(idx, cuts)):
            parts[u].extend(chunk)
    return [np.array(sorted(p), dtype=np.int64) for p in parts]


def build_client_arrays(x: np.ndarray, y: np.ndarray,
                        parts: Sequence[np.ndarray]):
    """Pack per-client data into equal-capacity stacked arrays.

    Returns (xs [N, M, ...], ys [N, M], counts [N]) where M is the max
    client size; rows beyond ``counts[i]`` are repeats.
    """
    N = len(parts)
    M = max(max(len(p) for p in parts), 1)
    xs = np.zeros((N, M) + x.shape[1:], dtype=x.dtype)
    ys = np.zeros((N, M) + y.shape[1:], dtype=y.dtype)
    counts = np.zeros((N,), dtype=np.int32)
    for i, p in enumerate(parts):
        n = len(p)
        counts[i] = n
        if n == 0:
            continue
        reps = int(np.ceil(M / n))
        sel = np.tile(p, reps)[:M]
        xs[i] = x[sel]
        ys[i] = y[sel]
    return xs, ys, counts
