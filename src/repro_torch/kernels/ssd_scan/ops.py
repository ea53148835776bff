"""Public SSD-scan op (counterpart of ``repro/kernels/ssd_scan/ops.py``).

``ssd_scan`` routes by the device of its inputs alone: CUDA tensors go to
the hand-written kernel (``csrc/ssd_scan.cu``), CPU tensors to the
sequential plain version in ``ref.py``. There is no fallback between the
two: a CUDA input the kernel cannot take raises.

The op is a ``torch.library`` custom op, so it runs under
``torch.func.vmap``: its vmap rule folds the batched dimensions (the
cross-test's testers and client models) into the op's batch and calls it
once, so a batched eval launches the kernel once a layer. ``A`` and ``D``
are params, one pair a client: the fold hands them on as ``[Bt, H]``, a
row a batch row, which the kernel reads through a batch stride (0 for the
shared ``[H]`` of the serve path). It has no gradient (the kernel is
forward-only): under a gradient it raises. :func:`ssd_chunked`, the twin
of the reference's ``_ssd_xla``, is the differentiable form local
training takes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.build import (
    batch_slices, divisor_block, load_library)
from repro_torch.kernels.ssd_scan.ref import ssd_ref

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
HEAD_DIMS = (32, 64)
STATE_SIZES = (16, 128)
MAX_CHUNK = 1024


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("ssd_scan"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, B, C, D, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 4:
        raise ValueError(f"ssd_scan wants x [Bt,S,H,P], dt [Bt,S,H] and B, C "
                         f"[Bt,S,G,N], got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(B.shape)}")
    Bt, S, H, _ = x.shape
    G = B.shape[2]
    per_head = ((H,), (Bt, H))
    if (tuple(dt.shape) != (Bt, S, H) or tuple(B.shape[:2]) != (Bt, S)
            or C.shape != B.shape or tuple(A.shape) not in per_head
            or tuple(D.shape) not in per_head):
        raise ValueError(f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)} (A and D are [H] or [Bt, H])")
    if S < 1 or H % G:
        raise ValueError(f"ssd_scan needs S >= 1 and H a multiple of G, got "
                         f"S={S}, H={H}, G={G}")
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    if x.dtype not in _ENTRY or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, B, C of one "
                        f"dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if not dt.dtype == A.dtype == D.dtype == torch.float32:
        raise TypeError(f"ssd_scan takes float32 dt, A, D, got {dt.dtype}, "
                        f"{A.dtype}, {D.dtype}")
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError("ssd_scan's inputs lie on more than one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")


def _rows(t: torch.Tensor, sl: slice) -> torch.Tensor:
    """A or D for the batch rows ``sl``: a ``[Bt, H]`` one's rows, a
    shared ``[H]`` one whole."""
    return t[sl] if t.dim() == 2 else t


def _launch(x, dt, A, B, C, D, chunk: int):
    """The CUDA kernel over x's batch, one launch a :func:`batch_slices`
    slice (a grid holds at most 65,535 batch rows)."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if P not in HEAD_DIMS or N not in STATE_SIZES:
        raise ValueError(f"the CUDA ssd_scan takes head dim P in {HEAD_DIMS} "
                         f"and state N in {STATE_SIZES}, got P={P}, N={N}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"the CUDA ssd_scan takes chunk <= {MAX_CHUNK}, got "
                         f"{chunk}")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("ssd_scan needs x, B and C unit-stride in their "
                         "last dimension")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssd_scan needs contiguous A and D")
    if x.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape)
                    if n > 1)
            for t in (x, B, C)):
        raise ValueError("the bf16 ssd_scan copies rows of x, B and C in "
                         "16-byte pieces: their data and their batch, row "
                         "and head strides must fall on 16-byte boundaries")
    y = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
    # the element strides of x, dt, B, C and y, then A's and D's batch
    # strides (0: one [H] for every row)
    strides = (ctypes.c_longlong * 17)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        *y.stride()[:3], H if A.dim() == 2 else 0, H if D.dim() == 2 else 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for sl in batch_slices(Bt):
            rc = _kernel(x.dtype)(
                x[sl].data_ptr(), dt[sl].data_ptr(), _rows(A, sl).data_ptr(),
                B[sl].data_ptr(), C[sl].data_ptr(), _rows(D, sl).data_ptr(),
                y[sl].data_ptr(), state[sl].data_ptr(), sl.stop - sl.start,
                S, H, G, P, N, chunk, strides, stream)
            if rc != 0:
                raise RuntimeError(
                    f"ssd_scan kernel launch failed with CUDA error {rc} (x "
                    f"{tuple(x.shape)}, B {tuple(B.shape)}, rows "
                    f"{sl.start}:{sl.stop}, chunk {chunk}, {x.dtype})")
            ssd_scan.launches += 1
    return y, state


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op on whole tensors: the plain version on the CPU, slice by
    slice as the kernel launches, else the kernel."""
    if x.device.type == "cpu":
        outs = [ssd_ref(x[sl], dt[sl], _rows(A, sl), B[sl], C[sl],
                        _rows(D, sl)) for sl in batch_slices(x.shape[0])]
        return (torch.cat([y for y, _ in outs]),
                torch.cat([s for _, s in outs]))
    return _launch(x, dt, A, B, C, D, chunk)


@_ssd_op.register_fake
def _(x, dt, A, B, C, D, chunk):
    Bt, S, H, P = x.shape
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty((Bt, H, P, B.shape[3]), dtype=torch.float32))


def _fold_rule(info, in_dims, x, dt, A, B, C, D, chunk):
    """vmap rule: the mapped dimension goes in front and folds into the
    batch, ``[n, Bt, ...] -> [n * Bt, ...]``, so the op (and the kernel)
    runs once for the whole map; nested maps fold level by level. dt, B
    and C unmapped are expanded to x's map. A and D, ``[H]`` or ``[Bt,
    H]``: unmapped ``[H]`` stays shared; mapped, or ``[Bt, H]``, becomes
    one row a folded batch row, ``[n * Bt, H]``. A mapped input with an
    unmapped x is refused (no caller makes one). The fold's reshape may
    copy, and the model's x, B and C (strided views of one conv output)
    lose their layout: what the rule hands on is made contiguous."""
    xd, dtd, ad, bd, cd, dd, _ = in_dims
    if xd is None:
        raise ValueError("ssd_scan under vmap maps x: a mapped dt, A, B, C "
                         "or D with an unmapped x has no rule")
    n = info.batch_size
    x = x.movedim(xd, 0)
    rows = x.shape[1]

    def fold(t, d):
        t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
        return t.reshape(n * rows, *t.shape[2:]).contiguous()

    def per_row(t, d):
        if d is None and t.dim() == 1:
            return t
        t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
        if t.dim() == 2:            # [n, H]: one row a map entry
            t = t[:, None].expand(n, rows, t.shape[1])
        return t.reshape(n * rows, t.shape[-1]).contiguous()

    y, state = _ssd_op(fold(x, 0), fold(dt, dtd), per_row(A, ad),
                       fold(B, bd), fold(C, cd), per_row(D, dd), chunk)
    return ((y.reshape(n, rows, *y.shape[1:]),
             state.reshape(n, rows, *state.shape[1:])), (0, 0))


_ssd_op.register_vmap(_fold_rule)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan over chunks of ``chunk`` rows (any S: the last chunk
    may be ragged). Shapes as in ``ref.ssd_ref`` (A and D ``[H]``, or
    ``[Bt, H]`` a row each); returns (y [Bt,S,H,P] in x's dtype, final
    state [Bt,H,P,N] f32). x, B and C are read through their strides, so
    slices of a wider tensor need no copy, as long as their last
    dimension is unit-stride (and, in bf16, their rows start on 16-byte
    boundaries). Each launch of the CUDA kernel adds one to
    ``ssd_scan.launches``; a batch over 65,535 rows takes one launch a
    slice of that many. A CUDA graph's replay launches the kernel
    without calling this wrapper and adds nothing: count a replay's
    launches from a profiler trace."""
    _check(x, dt, A, B, C, D, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, D)):
        raise RuntimeError("ssd_scan has no gradient (the kernel is "
                           "forward-only); differentiate ssd_chunked")
    return _ssd_op(x, dt, A, B, C, D, int(chunk))


ssd_scan.launches = 0


def _per_batch(t: torch.Tensor) -> torch.Tensor:
    """A or D as ``[Bt or 1, 1, H]``, broadcasting over a chunk's rows."""
    return t[:, None] if t.dim() == 2 else t[None, None]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD in plain tensor ops, the twin of the reference's
    ``_ssd_xla`` and the form local training differentiates: chunks of
    the largest divisor of S up to ``chunk``; per chunk the intra-chunk
    quadratic form ``((C Bᵀ) ∘ L) x``, the carried state's term
    ``exp(cum) (C h0ᵀ)`` and the skip ``D x``, then the state update,
    all in f32. The decay's exponent is masked to -1e30 above the
    diagonal before ``exp``: an ``inf`` there would poison the backward
    pass through the mask. A Python loop over chunks, no in-place writes,
    so it runs under ``vmap`` of ``grad``. Shapes as :func:`ssd_scan`."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    chunk = divisor_block(S, chunk)
    nc = S // chunk
    xf = x.float().reshape(Bt, nc, chunk, H, P)
    dtf = dt.float().reshape(Bt, nc, chunk, H)
    Bf = B.float().reshape(Bt, nc, chunk, G, N)
    Cf = C.float().reshape(Bt, nc, chunk, G, N)
    Af = _per_batch(A.float())                        # [Bt|1, 1, H]
    Df = _per_batch(D.float())[..., None]             # [Bt|1, 1, H, 1]
    idx = torch.arange(chunk, device=x.device)
    lower = idx[:, None] >= idx[None, :]
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xb, dtb = xf[:, c], dtf[:, c]                 # [Bt,Q,H,P], [Bt,Q,H]
        Bh = Bf[:, c].repeat_interleave(rep, dim=-2)  # [Bt,Q,H,N]
        Ch = Cf[:, c].repeat_interleave(rep, dim=-2)
        cum = torch.cumsum(dtb * Af, dim=1)           # inclusive
        CB = torch.einsum("bqhn,bkhn->bhqk", Ch, Bh)
        rel = cum[:, :, None, :] - cum[:, None, :, :]   # [Bt,q,k,H]
        rel = torch.where(lower[None, :, :, None], rel, -1e30)
        Lmat = torch.exp(rel) * dtb[:, None, :, :]
        y = torch.einsum("bhqk,bqkh,bkhp->bqhp", CB, Lmat, xb)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bqhn,bhpn->bqhp", Ch, h)
        y = y + Df * xb
        w = torch.exp(cum[:, -1:, :] - cum) * dtb     # [Bt,Q,H]
        h = (torch.exp(cum[:, -1, :])[..., None, None] * h
             + torch.einsum("bqhp,bqhn->bhpn", xb * w[..., None], Bh))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bt, S, H, P).to(x.dtype)
    return y, h
