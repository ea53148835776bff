"""Mamba2 (SSD) block, full-sequence chunked scan and single-token decode
(the port's side of ``repro/models/ssm.py``).

Block layout follows the Mamba2 paper: fused in-projection producing
(z, x, B, C, dt), short causal depthwise conv over (x, B, C), softplus dt,
the SSD scan (the ``ssd_scan`` kernel op for a sequence, or its
differentiable twin ``ssd_chunked`` that local training takes; the plain
recurrence ``ssd_decode_ref`` for one token), gated RMSNorm,
out-projection. Params keep the reference's tree: ``in_proj [D,
2 d_in + 2 G N + H]``, ``conv_w [W, conv_dim]``, ``conv_b``, ``out_proj
[d_in, D]`` in the model's dtype; ``dt_bias``, ``A_log``, ``D [H]`` and
``norm_scale.scale [d_in]`` in f32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_decode_ref, ssd_scan
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.sharding import per_device, shard_hint, sharded_reshape


def _dims(cfg):
    d_in = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    G = cfg.ssm_ngroups
    N = cfg.ssm_state
    conv_dim = d_in + 2 * G * N
    return d_in, H, P, G, N, conv_dim


def ssm_specs(cfg, dtype) -> Dict:
    """Leaf shapes and dtypes of one Mamba2 block: ``{name: (shape,
    dtype)}``."""
    D = cfg.d_model
    d_in, H, P, G, N, conv_dim = _dims(cfg)
    W = cfg.ssm_conv_width
    f32 = torch.float32
    return {"in_proj": ((D, 2 * d_in + 2 * G * N + H), dtype),
            "conv_w": ((W, conv_dim), dtype),
            "conv_b": ((conv_dim,), dtype),
            "dt_bias": ((H,), f32),
            "A_log": ((H,), f32),
            "D": ((H,), f32),
            "norm_scale": {"scale": ((d_in,), f32)},
            "out_proj": ((d_in, D), dtype)}


def ssm_init(gen: torch.Generator, cfg, dtype, lead=()) -> Dict:
    """Fresh params drawn on ``gen``'s device, as the reference draws
    them; ``lead`` prepends stacked axes (the decoder's layer axis):
    projections fan-in truncated normal, ``conv_w`` N(0, 1/W), ``A_log``
    the log of ``linspace(1, 16, H)``, ``D`` and the norm scale one,
    biases zero."""
    specs = ssm_specs(cfg, dtype)
    dev = gen.device
    H = cfg.ssm_heads

    def full(name, value):
        shape, dt = specs[name]
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    conv_shape, _ = specs["conv_w"]
    conv_w = torch.empty(lead + conv_shape, dtype=torch.float32, device=dev)
    conv_w.normal_(0.0, 1.0, generator=gen)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=dev))
    return {
        "in_proj": dense_init(gen, lead + specs["in_proj"][0],
                              in_axis=len(lead), dtype=dtype),
        "conv_w": (conv_w * cfg.ssm_conv_width ** -0.5).to(dtype),
        "conv_b": full("conv_b", 0.0),
        "dt_bias": full("dt_bias", 0.0),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": full("D", 1.0),
        "norm_scale": {"scale": torch.ones(
            lead + specs["norm_scale"]["scale"][0], dtype=torch.float32,
            device=dev)},
        "out_proj": dense_init(gen, lead + specs["out_proj"][0],
                               in_axis=len(lead), dtype=dtype),
    }


def _split_proj(proj: torch.Tensor, cfg):
    d_in, H, P, G, N, conv_dim = _dims(cfg)
    z = proj[..., :d_in]
    rest = proj[..., d_in:d_in + conv_dim]
    dt = proj[..., d_in + conv_dim:]
    return z, rest, dt                          # rest = (x, B, C) pre-conv


def _split_conv_out(u: torch.Tensor, cfg):
    d_in, H, P, G, N, _ = _dims(cfg)
    x = u[..., :d_in]
    Bm = u[..., d_in:d_in + G * N]
    Cm = u[..., d_in + G * N:]
    return x, Bm, Cm


def _causal_conv(u: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor) -> torch.Tensor:
    W = conv_w.shape[0]
    S = u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * conv_w[i] for i in range(W))
    return out + conv_b


def _causal_conv_full(p, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u [B,S,C] -> [B,S,C]; on the dry-run's
    DTensors device by device over batch and channels."""
    return per_device(_causal_conv, [(u, 0, 2), (p["conv_w"], None, 1),
                                     (p["conv_b"], None, 0)], [(0, 2)])


def _conv_tail(pre: torch.Tensor, W: int) -> torch.Tensor:
    """The last W-1 rows of ``pre`` [B,S,C], zero-padded in front when
    S < W-1."""
    S = pre.shape[1]
    return F.pad(pre, (0, 0, W - 1, 0))[:, S:S + W - 1]


def _gate_out(p, cfg, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm of y by silu(z), then the out-projection."""
    y = rms_norm(p["norm_scale"], y * F.silu(z.float()).to(y.dtype),
                 cfg.norm_eps)
    return y @ p["out_proj"]


def ssm_full(p, cfg, x: torch.Tensor, *, return_state: bool = False,
             differentiable: bool = False):
    """x [B,S,D] -> y [B,S,D] (+ (conv_state [B,W-1,conv_dim], ssm_state
    [B,H,P,N] f32) for the serve hand-off). The scan's x, B and C are
    views of the conv output, which the kernel reads in place (under
    vmap, its fold rule copies them). The scan is ``ssd_scan`` or, with
    ``differentiable``, ``ssd_chunked``."""
    B, S, _ = x.shape
    d_in, H, P, G, N, conv_dim = _dims(cfg)
    W = cfg.ssm_conv_width

    proj = x @ p["in_proj"]
    z, pre, dt_raw = _split_proj(proj, cfg)
    u = F.silu(_causal_conv_full(p, pre).float()).to(x.dtype)
    xs, Bm, Cm = _split_conv_out(u, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    scan = ssd_chunked if differentiable else ssd_scan
    xs = shard_hint(sharded_reshape(xs, (B, S, H, P)),
                    ("batch", "seq", "heads", None))
    # on the dry-run's DTensors, device by device over batch and heads
    y, state = per_device(
        scan, [(xs, 0, 2), (dt, 0, 2), (A, None, 0),
               (sharded_reshape(Bm, (B, S, G, N)), 0, None),
               (sharded_reshape(Cm, (B, S, G, N)), 0, None),
               (p["D"], None, 0)],
        [(0, 2), (0, 1)], chunk=cfg.ssm_chunk)
    out = shard_hint(_gate_out(p, cfg, sharded_reshape(y, (B, S, d_in)), z),
                     ("batch", "seq", "embed"))
    if return_state:
        conv_state = per_device(_conv_tail, [(pre, 0, 2)], [(0, 2)], W=W)
        return out, (conv_state, state)
    return out


def ssm_decode(p, cfg, x: torch.Tensor, conv_state: torch.Tensor,
               ssm_state: torch.Tensor
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token recurrent step. x [B,1,D]; conv_state [B,W-1,conv_dim];
    ssm_state [B,H,P,N] f32. Returns (y [B,1,D], (new conv state, new
    ssm state)); the inputs are not modified."""
    B = x.shape[0]
    d_in, H, P, G, N, conv_dim = _dims(cfg)

    proj = x[:, 0] @ p["in_proj"]                  # [B, proj_dim]
    z, pre, dt_raw = _split_proj(proj, cfg)
    window = torch.cat([conv_state, pre[:, None, :]], dim=1)   # [B,W,C]
    u = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    u = F.silu(u.float()).to(x.dtype)
    xs, Bm, Cm = _split_conv_out(u, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    # on the dry-run's DTensors, device by device over batch and heads
    y, ssm_state = per_device(
        ssd_decode_ref, [(sharded_reshape(xs, (B, H, P)), 0, 1), (dt, 0, 1),
                         (A, None, 0), (sharded_reshape(Bm, (B, G, N)), 0, None),
                         (sharded_reshape(Cm, (B, G, N)), 0, None),
                         (p["D"], None, 0), (ssm_state, 0, 1)],
        [(0, 1), (0, 1)])
    out = _gate_out(p, cfg, sharded_reshape(y, (B, d_in)), z)[:, None, :]
    return out, (window[:, 1:], ssm_state)

