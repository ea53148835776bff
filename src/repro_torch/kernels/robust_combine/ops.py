"""Public per-coordinate robust-combine op (counterpart of
``repro/kernels/robust_combine/ops.py``).

``robust_combine`` reduces a ``[C, M]`` stack of flattened client updates
to one ``[M]`` update with a per-coordinate order statistic — trimmed
mean or median — instead of a weighted sum. Both statistics are one
mechanism: sort each coordinate's C values ascending (masked clients
last), then dot the sorted stack with the ``[C]`` sorted-position
weights of :func:`row_select_weights`.

``combine_rows`` routes by the device of its input alone: a CUDA tensor
goes to the hand-written kernel (``csrc/robust_combine.cu``), a CPU
tensor to the plain network version in ``ref.py``. There is no fallback
between the two: a CUDA input the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.robust_combine.ref import (
    robust_combine_network_ref)

MODES = ("trimmed_mean", "median")
# the kernel keeps a column in registers up to C = 128 (a network per C
# up to 64, padded to REGISTER_PADS above) and stages it in shared memory
# above that, up to the C whose 32 columns fill a block's 227 KB
# (csrc/robust_combine.cu); the CUDA route refuses more
MAX_CLIENTS = 1816


def row_select_weights(mask: torch.Tensor, *, mode: str = "trimmed_mean",
                       trim_fraction: float = 0.2) -> torch.Tensor:
    """Sorted-position selection weights for a masked robust combine.

    ``mask`` [C] (>0 = client participates) -> ``w_row`` [C] f32 over the
    ascending-sorted positions, masked clients occupying the tail:

    * ``trimmed_mean``: drop ``floor(trim_fraction * k)`` from each end
      of the k participating values (at least one value is always kept),
      uniform over the rest;
    * ``median``: 0.5/0.5 on positions (k-1)//2 and k//2.

    An all-zero mask gives all-zero weights, so the combined update is
    exactly zero. Torch ops on the mask's device: nothing is read back to
    the host.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "trimmed_mean" and not 0.0 <= trim_fraction < 1.0:
        raise ValueError(f"trim_fraction in [0, 1), got {trim_fraction}")
    m = mask.float()
    k_raw = torch.round(m.sum()).to(torch.int32)
    nonempty = (k_raw > 0).float()
    k = torch.clamp(k_raw, min=1)
    idx = torch.arange(m.shape[0], dtype=torch.int32, device=m.device)
    if mode == "median":
        w = 0.5 * (idx == (k - 1) // 2) + 0.5 * (idx == k // 2)
        return (w * nonempty).float()
    t = torch.floor(trim_fraction * k).to(torch.int32)
    t = torch.minimum(t, (k - 1) // 2)
    keep = k - 2 * t
    w = torch.where((idx >= t) & (idx < k - t), 1.0 / keep, 0.0)
    return (w * nonempty).float()


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("robust_combine").robust_combine_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def combine_rows(x: torch.Tensor, mask: torch.Tensor,
                 w_row: torch.Tensor) -> torch.Tensor:
    """x [C, M] f32; mask [C]; w_row [C] sorted-position weights -> [M].

    Each launch of the CUDA kernel adds one to ``robust_combine.launches``.
    A CUDA graph's replay launches the kernel without calling this
    wrapper and adds nothing: count a replay's launches from a profiler
    trace.
    """
    C = x.shape[0] if x.dim() == 2 else -1
    if C < 1 or mask.shape != (C,) or w_row.shape != (C,):
        raise ValueError(f"robust_combine wants x [C, M], mask [C] and "
                         f"w_row [C], got {tuple(x.shape)}, "
                         f"{tuple(mask.shape)} and {tuple(w_row.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"robust_combine takes float32 updates, got "
                        f"{x.dtype}")
    if not x.device == mask.device == w_row.device:
        raise ValueError(f"x on {x.device}, mask on {mask.device}, w_row "
                         f"on {w_row.device}")
    if x.device.type == "cpu":
        return robust_combine_network_ref(x, mask, w_row)
    if x.device.type != "cuda":
        raise ValueError(f"robust_combine runs on cuda or cpu, not "
                         f"{x.device}")
    if C > MAX_CLIENTS:
        raise ValueError(f"the robust_combine kernel takes at most "
                         f"{MAX_CLIENTS} clients, got C={C}")
    if mask.dtype != torch.float32 or w_row.dtype != torch.float32:
        raise TypeError(f"robust_combine takes a float32 mask and w_row, "
                        f"got {mask.dtype} and {w_row.dtype}")
    if not (x.is_contiguous() and mask.is_contiguous()
            and w_row.is_contiguous()):
        raise ValueError("robust_combine needs contiguous x, mask and w_row")
    M = x.shape[1]
    out = torch.empty((M,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel()(x.data_ptr(), mask.data_ptr(), w_row.data_ptr(),
                       out.data_ptr(), C, M, stream)
    if rc != 0:
        raise RuntimeError(f"robust_combine kernel launch failed with CUDA "
                           f"error {rc} (C={C}, M={M})")
    robust_combine.launches += 1
    return out


def robust_combine(x: torch.Tensor, mask: torch.Tensor = None, *,
                   mode: str = "trimmed_mean",
                   trim_fraction: float = 0.2) -> torch.Tensor:
    """x [C, M] f32 client updates -> [M] per-coordinate robust combine.

    ``mask`` [C] (optional): clients with ``mask <= 0`` are left out of
    the order statistic.
    """
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=torch.float32,
                          device=x.device)
    w_row = row_select_weights(mask, mode=mode, trim_fraction=trim_fraction)
    return combine_rows(x, mask.float(), w_row)


robust_combine.launches = 0
