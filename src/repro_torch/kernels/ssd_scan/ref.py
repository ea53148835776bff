"""Plain PyTorch version of the Mamba2 SSD recurrence, the sequential
oracle of ``repro/kernels/ssd_scan/ref.py``:

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * (x_t outer B_t)     h in R^{P x N}
    y_t = h_t @ C_t + D_h * x_t

Shapes: x [Bt,S,H,P]; dt [Bt,S,H] (post-softplus); A [H] (negative);
B, C [Bt,S,G,N] (G state groups, head h reads group h // (H/G)); D [H].
A and D may also be [Bt, H], one row a batch row (a vmapped eval folds
each client's own into the batch).
The recurrence runs in fp32; y comes back in x's dtype, the state in
fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _heads(a: torch.Tensor, H: int, dim: int) -> torch.Tensor:
    """[..., G, N] groups -> [..., H, N] heads, each group repeated over
    its H // G consecutive heads, in fp32."""
    return a.float().repeat_interleave(H // a.shape[dim], dim=dim)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan one row at a time. Returns (y [Bt,S,H,P] in x's dtype,
    final state [Bt,H,P,N] fp32); ``init_state`` defaults to zeros."""
    Bt, S, H, P = x.shape
    N = B.shape[3]
    Bh = _heads(B, H, 2)                                  # [Bt,S,H,N]
    Ch = _heads(C, H, 2)
    xf, dtf = x.float(), dt.float()
    h = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        xt, dtt = xf[:, t], dtf[:, t]                     # [Bt,H,P], [Bt,H]
        decay = torch.exp(dtt * A)[..., None, None]       # [Bt,H,1,1]
        upd = dtt[..., None, None] * xt[..., :, None] * Bh[:, t, :, None, :]
        h = decay * h + upd                               # [Bt,H,P,N]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t])
                  + D[..., None] * xt)
    y = (torch.stack(ys, dim=1) if ys
         else xf.new_zeros((Bt, 0, H, P)))
    return y.to(x.dtype), h


def ssd_decode_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   state: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update. x [Bt,H,P]; dt [Bt,H]; B, C
    [Bt,G,N]; state [Bt,H,P,N] -> (y [Bt,H,P] in x's dtype, new state
    fp32)."""
    H = x.shape[1]
    Bh = _heads(B, H, 1)
    Ch = _heads(C, H, 1)
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A)[..., None, None]
    state = (decay * state
             + dtf[..., None, None] * xf[..., :, None] * Bh[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + D[..., None] * xf
    return y.to(x.dtype), state
