"""Synthetic datasets: images (offline stand-ins for CIFAR-10 / MNIST)
and a token stream for the LMs.

A copy of the numpy generators of ``repro/data/synthetic.py``: plain
numpy seeded with ``default_rng``, so the port's arrays are bitwise equal
to the reference's for the same seed. Each image class c has a smooth
random prototype; a sample is the prototype under a random shift plus
Gaussian noise. A token sequence follows its topic's affine bigram chain
with noise tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageSpec:
    name: str
    image_size: int
    channels: int
    num_classes: int
    noise: float
    shift: int
    smooth: int


CIFAR_LIKE = ImageSpec("cifar_like", 32, 3, 10, noise=0.9, shift=4, smooth=4)
MNIST_LIKE = ImageSpec("mnist_like", 28, 1, 10, noise=0.45, shift=2, smooth=3)


def _smooth(x: np.ndarray, k: int) -> np.ndarray:
    """Cheap box-blur along spatial dims to create low-frequency prototypes."""
    for axis in (0, 1):
        acc = np.zeros_like(x)
        for d in range(-k, k + 1):
            acc += np.roll(x, d, axis=axis)
        x = acc / (2 * k + 1)
    return x


def make_image_dataset(spec: ImageSpec, num_samples: int, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images [N,H,W,C] f32, labels [N] i32)."""
    rng = np.random.default_rng(seed)
    H = spec.image_size
    protos = rng.normal(size=(spec.num_classes, H, H, spec.channels))
    protos = np.stack([_smooth(p, spec.smooth) for p in protos])
    protos /= protos.std(axis=(1, 2, 3), keepdims=True) + 1e-8

    labels = rng.integers(0, spec.num_classes, size=num_samples)
    shifts = rng.integers(-spec.shift, spec.shift + 1, size=(num_samples, 2))
    images = protos[labels]
    for i in range(num_samples):
        images[i] = np.roll(images[i], tuple(shifts[i]), axis=(0, 1))
    images = images + rng.normal(scale=spec.noise,
                                 size=images.shape)
    return images.astype(np.float32), labels.astype(np.int32)


def make_token_stream(vocab: int, num_seqs: int, seq_len: int,
                      num_topics: int = 8, seed: int = 0,
                      noise: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic LM data: per-topic affine bigram chains + noise tokens.

    Returns (tokens [N,S] i32, topics [N] i32). ``labels`` for next-token
    training are ``tokens`` shifted by the caller.
    """
    rng = np.random.default_rng(seed)
    a = rng.integers(2, 17, size=num_topics)        # per-topic multiplier
    b = rng.integers(0, vocab, size=num_topics)     # per-topic offset
    topics = rng.integers(0, num_topics, size=num_seqs)
    toks = np.empty((num_seqs, seq_len), dtype=np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=num_seqs)
    for t in range(1, seq_len):
        nxt = (toks[:, t - 1] * a[topics] + b[topics]) % vocab
        noise_mask = rng.random(num_seqs) < noise
        nxt = np.where(noise_mask, rng.integers(0, vocab, size=num_seqs), nxt)
        toks[:, t] = nxt
    return toks.astype(np.int32), topics.astype(np.int32)
