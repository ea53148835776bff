"""The one generator of the benchmark's inputs: a traffic file's
``data`` parameters and a seed -> every client's shards, on the device,
in a few large draws from one ``torch.Generator``. The same seed gives the
same shards on the same device; every seed gives the same sizes.

``images``: class-conditional images. Each class has a smooth prototype
(a Gaussian field on a ``proto_cell``-times coarser grid, repeated up);
a client draws ``skew`` of its labels from its ``dominant`` classes and
the rest uniformly (non-IID shards, as the paper's partition), each image
its prototype plus ``noise`` times white noise. ``tokens``: per-client
topic-skewed token streams, next-token labels.
"""
from __future__ import annotations

from typing import Dict

import torch

# a stream a purpose, so the data, the weights and the round's generator
# never share draws
DATA, WEIGHTS, ROUNDS = 1, 2, 3


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``(seed, stream)``; any whole ``seed``."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def _labels(gen, users: int, rows: int, classes: int, dominant: int,
            skew: float) -> torch.Tensor:
    """``[users, rows]`` int32 labels: ``skew`` of them from each user's
    ``dominant`` classes, the rest uniform."""
    dev = gen.device
    own = torch.randint(0, classes, (users, dominant), generator=gen,
                        device=dev)
    pick = torch.randint(0, dominant, (users, rows), generator=gen,
                         device=dev)
    uniform = torch.randint(0, classes, (users, rows), generator=gen,
                            device=dev)
    u = torch.rand((users, rows), generator=gen, device=dev)
    return torch.where(u < skew, own.gather(1, pick), uniform).to(torch.int32)


def make_images(spec: dict, cfg: dict, users: int, seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """Every client's train and test shards and the global and server
    sets, f32 NHWC images and int32 labels."""
    gen = generator(seed, DATA, device)
    size, ch, classes = cfg["image_size"], cfg["image_channels"], \
        cfg["num_classes"]
    cell = spec["proto_cell"]
    coarse = torch.randn((classes, -(-size // cell), -(-size // cell), ch),
                         generator=gen, device=device)
    protos = (coarse.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
              [:, :size, :size])
    rows = spec["train_rows"] + spec["test_rows"]
    labels = _labels(gen, users, rows, classes, spec["dominant"],
                     spec["skew"])
    extra = spec["global_rows"] + spec["server_rows"]
    flat = torch.cat([labels.reshape(-1),
                      torch.randint(0, classes, (extra,), generator=gen,
                                    device=device, dtype=torch.int32)])
    noise = torch.randn((flat.numel(), size, size, ch), generator=gen,
                        device=device)
    images = noise.mul_(spec["noise"]).add_(protos[flat.long()])
    n = users * rows
    xs = images[:n].reshape(users, rows, size, size, ch)
    tr = spec["train_rows"]
    g = spec["global_rows"]
    return {"train_x": xs[:, :tr], "train_y": labels[:, :tr],
            "test_x": xs[:, tr:], "test_y": labels[:, tr:],
            "counts": torch.full((users,), tr, dtype=torch.int32,
                                 device=device),
            "global_x": images[n:n + g], "global_y": flat[n:n + g],
            "server_x": images[n + g:], "server_y": flat[n + g:]}


def make_tokens(spec: dict, cfg: dict, users: int, seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """Topic-skewed token shards: each client's sequences draw ``skew`` of
    their tokens from its own topic's ``topic_vocab`` ids and the rest
    uniformly over the vocabulary; labels are the next tokens."""
    gen = generator(seed, DATA, device)
    vocab, seq = cfg["vocab_size"], spec["seq_len"]
    rows = spec["train_rows"] + spec["test_rows"]
    extra = spec["global_rows"] + spec["server_rows"]
    total = users * rows + extra
    topic = torch.cat([torch.arange(users, device=device)
                       .repeat_interleave(rows),
                       torch.randint(0, users, (extra,), generator=gen,
                                     device=device)])
    base = torch.randint(0, vocab - spec["topic_vocab"], (users,),
                         generator=gen, device=device)
    own = base[topic][:, None] + torch.randint(
        0, spec["topic_vocab"], (total, seq + 1), generator=gen,
        device=device)
    uniform = torch.randint(0, vocab, (total, seq + 1), generator=gen,
                            device=device)
    u = torch.rand((total, seq + 1), generator=gen, device=device)
    toks = torch.where(u < spec["skew"], own, uniform)
    x, y = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    n = users * rows
    tr, g = spec["train_rows"], spec["global_rows"]
    xs, ys = x[:n].reshape(users, rows, seq), y[:n].reshape(users, rows, seq)
    return {"train_x": xs[:, :tr], "train_y": ys[:, :tr],
            "test_x": xs[:, tr:], "test_y": ys[:, tr:],
            "counts": torch.full((users,), tr, dtype=torch.int32,
                                 device=device),
            "global_x": x[n:n + g], "global_y": y[n:n + g],
            "server_x": x[n + g:], "server_y": y[n + g:]}


def make_population(spec: dict, cfg: dict, users: int, seed: int, device
                    ) -> Dict[str, torch.Tensor]:
    """A keyed population: the class prototypes (standard normal fields),
    the Philox key of its shards, and the global and server sets drawn
    from that key (streams 2, clients 0 and 1). A client's shard exists
    only when a round draws it."""
    from fedbench.reference import population
    gen = generator(seed, DATA, device)
    protos = torch.randn((cfg["num_classes"], cfg["image_size"],
                          cfg["image_size"], cfg["image_channels"]),
                         generator=gen, device=device)
    word = stream_seed(seed, DATA + 10)
    key = (word & 0xFFFFFFFF, word >> 32)
    out = {"protos": protos, "shard_key": key}
    for name, client, rows in (("global", 0, spec["global_rows"]),
                               ("server", 1, spec["server_rows"])):
        x, y = population.shards(key, protos, spec["noise"],
                                 population.GLOBAL,
                                 torch.tensor([client], device=device), rows)
        out[f"{name}_x"], out[f"{name}_y"] = x[0], y[0]
    return out


MAKERS = {"images": make_images, "tokens": make_tokens,
          "population": make_population}


def make_data(traffic: dict, cfg: dict, seed: int, device):
    spec = traffic["data"]
    return MAKERS[spec["kind"]](spec, cfg, traffic["fed"]["num_users"],
                                seed, device)
