"""Modality-frontend stubs (the port's side of
``repro/models/frontend_stub.py``).

The audio conv/mel feature extractor (whisper) and the ViT and projector
(pixtral) are not implemented, in the reference either: the models take
precomputed frame or patch embeddings of the right shape,

* audio:  ``[B, encoder_seq (1500), d_model]``
* vision: ``[B, num_patches, d_model]``

and ``stub_embeddings`` draws deterministic stand-ins for them from an
explicit ``torch.Generator``, so they differ from the reference's JAX
draws (a test hands both packages the same numpy embeddings).
``stub_spec`` is the dry-run's stand-in, the twin of the reference's
``ShapeDtypeStruct``: a fake tensor that allocates nothing.
"""
from __future__ import annotations

import torch


def stub_shape(cfg, batch: int):
    if cfg.frontend == "audio":
        return (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.frontend == "vision":
        return (batch, cfg.num_patches, cfg.d_model)
    raise ValueError(f"{cfg.name} has no frontend stub")


def stub_spec(cfg, batch: int, dtype=torch.bfloat16, *, mode=None):
    """The frontend's activations as a shape-and-dtype stand-in: a fake
    tensor on the ``cpu`` device of ``mode`` (a ``FakeTensorMode``; a
    fresh one by default)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with mode or FakeTensorMode():
        return torch.empty(stub_shape(cfg, batch), dtype=dtype, device="cpu")


def stub_embeddings(cfg, batch: int, gen: torch.Generator,
                    dtype=torch.float32) -> torch.Tensor:
    """Stand-in frontend activations: N(0, 1) draws from ``gen`` in f32 on
    its device, cast to ``dtype``, times 0.02 (the reference's order)."""
    x = torch.empty(stub_shape(cfg, batch), dtype=torch.float32,
                    device=gen.device)
    x.normal_(0.0, 1.0, generator=gen)
    return x.to(dtype) * 0.02
