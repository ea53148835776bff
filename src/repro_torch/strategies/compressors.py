"""Pluggable update compressors: the wire format of the exchange
(counterpart of ``repro/strategies/compressors.py``, DESIGN.md §12).

With a compressor other than ``identity`` (``FedConfig.compressor``),
each participating client ships its flat update (``model - global``, the
``[D]`` f32 layout of the round's update matrix) encoded, and everything
downstream — cross-testing, scoring, aggregation — sees only the decoded
reconstruction. Every compressor exposes::

    payload, new_state = comp.encode(state, update)   # [..., D] f32 in
    update_hat         = comp.decode(payload)         # [..., D] f32 out

``state`` is the client's error-feedback buffer (all-zero at init):
``encode`` compresses the compensated update ``update + state`` and
banks the residual, so decoded payloads plus the final residual sum to
the raw updates over rounds. Leading axes are clients: the round encodes
all ``[N, D]`` rows at once, each with the arithmetic of one row.

All compressors are deterministic and key-free (fedlint FL001: they
consume no random stream); the engine injects ``dim``, the flat update
width, as a build default.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.dequant_aggregate import dequant_aggregate
from repro_torch.kernels.weighted_aggregate import weighted_aggregate
from repro_torch.strategies.base import Registry, register

COMPRESSORS = Registry("compressor")


class Compressor:
    """Encode/decode flat ``[..., D]`` f32 updates. Subclasses implement
    :meth:`_compress` (the lossy projection to a payload dict) and
    :meth:`decode`; the error-feedback banking in :meth:`encode` is
    shared."""

    name = "base"
    # aggregate() reads the decoded [C, D] stack; False where it reads the
    # payloads alone (int8), so the pod gathers only those
    reads_decoded = True

    def __init__(self, dim: int):
        self.dim = int(dim)
        if self.dim <= 0:
            raise ValueError(f"dim must be positive, got {dim}")

    def init_state(self, num_users: int, device=None) -> torch.Tensor:
        """All-zero ``[N, D]`` f32 error-feedback buffer."""
        return torch.zeros((int(num_users), self.dim), dtype=torch.float32,
                           device=device)

    def _compress(self, compensated: torch.Tensor) -> dict:
        raise NotImplementedError

    def encode(self, state, update):
        """``(payload, new_state)`` with error feedback banked."""
        if update.shape[-1:] != (self.dim,) or state.shape != update.shape:
            raise ValueError(
                f"compressors operate on flat [..., {self.dim}] updates "
                f"and states of one shape, got {tuple(update.shape)} and "
                f"{tuple(state.shape)}")
        compensated = update.float() + state.float()
        payload = self._compress(compensated)
        return payload, compensated - self.decode(payload)

    def decode(self, payload) -> torch.Tensor:
        raise NotImplementedError

    def aggregate(self, payloads, decoded, weights) -> torch.Tensor:
        """Weighted sum of the decoded updates, ``[C, D] x [C] -> [D]``,
        through the ``weighted_aggregate`` kernel; ``int8`` overrides it
        with the fused ``dequant_aggregate`` kernel."""
        return weighted_aggregate(decoded, weights)

    def payload_bytes(self, payload) -> int:
        """Wire bytes of one client's payload (a payload of one row)."""
        return sum(t.numel() * t.element_size() for t in payload.values())

    def __repr__(self) -> str:
        return f"<compressor {self.name} dim={self.dim}>"


@register(COMPRESSORS, "identity")
class Identity(Compressor):
    """Dense f32 exchange. The engine never threads it: ``identity``
    switches the seam off, so the default round stays the uncompressed
    one."""

    def _compress(self, compensated):
        return {"dense": compensated}

    def decode(self, payload):
        return payload["dense"].float()


@register(COMPRESSORS, "topk")
class TopK(Compressor):
    """Top-k magnitude sparsification: ship the ``k`` largest-|value|
    coordinates as (values f32, indices int32). ``k`` is a fraction of
    ``dim`` below 1, else a count."""

    def __init__(self, dim: int, k: float = 0.05):
        super().__init__(dim)
        k = float(k)
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        self.k = max(1, int(round(k * self.dim))) if k < 1.0 else int(k)
        self.k = min(self.k, self.dim)

    def _compress(self, compensated):
        idx = torch.topk(compensated.abs(), self.k, dim=-1).indices
        return {"values": torch.gather(compensated, -1, idx),
                "indices": idx.to(torch.int32)}

    def decode(self, payload):
        values = payload["values"].float()
        dense = torch.zeros(values.shape[:-1] + (self.dim,),
                            dtype=torch.float32, device=values.device)
        return dense.scatter(-1, payload["indices"].long(), values)


@register(COMPRESSORS, "int8")
class Int8(Compressor):
    """Per-chunk absmax-scaled int8 quantisation: the update is padded to
    a whole number of ``chunk``-wide chunks, ``scale = max|chunk| / 127``
    (floored at 1e-12 so all-zero chunks stay exact), ``q =
    round(x / scale)`` clipped to [-127, 127]. The payload is (q int8
    [D_pad], scales f32 [D_pad / chunk]); the server aggregates it with
    the fused ``dequant_aggregate`` kernel, which never writes the f32
    ``[C, D]`` stack."""

    reads_decoded = False

    def __init__(self, dim: int, chunk: int = 256):
        super().__init__(dim)
        self.chunk = int(chunk)
        if self.chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.padded_dim = -(-self.dim // self.chunk) * self.chunk
        self.num_chunks = self.padded_dim // self.chunk

    def _compress(self, compensated):
        x = F.pad(compensated, (0, self.padded_dim - self.dim))
        chunks = x.reshape(x.shape[:-1] + (self.num_chunks, self.chunk))
        absmax = chunks.abs().amax(dim=-1)
        scales = torch.clamp(absmax / 127.0, min=1e-12)
        q = torch.clamp(torch.round(chunks / scales[..., None]), -127, 127)
        return {"q": q.to(torch.int8).reshape(x.shape), "scales": scales}

    def decode(self, payload):
        q = payload["q"].float()
        lead = q.shape[:-1]
        dec = (q.reshape(lead + (self.num_chunks, self.chunk))
               * payload["scales"].float()[..., None]).reshape(
                   lead + (self.padded_dim,))
        return dec[..., :self.dim]

    def aggregate(self, payloads, decoded, weights):
        out = dequant_aggregate(weights, payloads["scales"], payloads["q"],
                                chunk=self.chunk)
        return out[:self.dim]


@register(COMPRESSORS, "lowrank")
class LowRank(Compressor):
    """Rank-r factorisation: the update, reshaped to a near-square
    ``[a, b]`` matrix, is projected onto its top-``rank`` subspace by
    ``iters`` rounds of QR subspace iteration from a deterministic
    cosine-ramp start. The payload is (U [a, rank], V [b, rank]) f32;
    ``decode`` returns ``(U @ V^T).ravel()``."""

    def __init__(self, dim: int, rank: int = 4, iters: int = 2):
        super().__init__(dim)
        self.rank = int(rank)
        self.iters = int(iters)
        if self.rank <= 0:
            raise ValueError(f"rank must be positive, got {rank}")
        if self.iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        a = max(1, int(math.sqrt(self.dim)))
        self.rows = a
        self.cols = (self.dim + a - 1) // a
        self.rank = min(self.rank, self.rows, self.cols)

    def _seed_basis(self, device) -> torch.Tensor:
        """Deterministic full-column-rank ``[cols, rank]`` start."""
        i = torch.arange(self.cols, dtype=torch.float32, device=device)
        j = torch.arange(self.rank, dtype=torch.float32, device=device)
        return torch.cos(0.5 + i[:, None] * (j[None, :] + 1.0) * 0.618)

    def _compress(self, compensated):
        pad = self.rows * self.cols - self.dim
        mat = F.pad(compensated, (0, pad)).reshape(
            compensated.shape[:-1] + (self.rows, self.cols))
        v = torch.linalg.qr(self._seed_basis(compensated.device)).Q
        for _ in range(self.iters):
            u = torch.linalg.qr(mat @ v).Q
            v = torch.linalg.qr(mat.transpose(-1, -2) @ u).Q
        return {"u": mat @ v, "v": v}

    def decode(self, payload):
        u, v = payload["u"].float(), payload["v"].float()
        out = u @ v.transpose(-1, -2)
        return out.reshape(out.shape[:-2] + (-1,))[..., :self.dim]
