"""Top-k mixture-of-experts FFN (the port's side of ``repro/models/moe.py``).

Two routes, as in the reference:

* :func:`moe_apply` — the capacity dispatch of GShard/Switch: the tokens
  are split into groups of ``group_size``; inside a group each token's
  top-k experts get a slot of capacity C = ceil(top_k * group *
  CAPACITY_FACTOR / E), taken in token order by a cumsum, and a choice
  past C is dropped to the residual path. Dispatch and combine are
  one-hot contractions.
* :func:`moe_dropless` — every expert runs on every token, combined with
  the renormalised top-k gates: the routing of a token does not depend on
  the others in its batch (the decode path's).

Both return the Switch load-balance loss ``aux`` as the reference forms it
on that route (the two forms differ). The expert products are batched
matmuls over E (``[E, T, D] @ [E, D, F]``), so the ``[E, D, F]`` banks
are read in place, never permuted into a copy. Params keep the
reference's tree: ``router [D, E]`` in f32, ``w_gate``, ``w_up [E, D,
F]`` and ``w_down [E, F, D]`` in the model's dtype. The top k break ties
toward the lower expert, as ``jax.lax.top_k`` does (:func:`_route`).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.sharding import shard_hint, sharded_reshape

DEFAULT_GROUP = 512
CAPACITY_FACTOR = 1.25


def moe_specs(cfg, dtype) -> Dict:
    """Leaf shapes and dtypes of one MoE FFN: ``{name: (shape, dtype)}``;
    the router stays f32."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": ((D, E), torch.float32),
            "w_gate": ((E, D, Fd), dtype), "w_up": ((E, D, Fd), dtype),
            "w_down": ((E, Fd, D), dtype)}


def moe_init(gen: torch.Generator, cfg, dtype, lead=()) -> Dict:
    """Fresh params on ``gen``'s device; ``lead`` prepends stacked axes.
    Fan-in truncated normal throughout (an expert bank's fan-in is its
    axis 1). Each expert bank is drawn one ``[E, ...]`` slice of ``lead``
    at a time into its preallocated stack, so the f32 draw never holds
    more than one layer's bank (at ``qwen3-moe-30b-a3b``'s widths a
    whole ``[48, 128, 2048, 768]`` bank would be a 38.7 GB f32
    temporary)."""
    specs = moe_specs(cfg, dtype)
    shape, dt = specs["router"]
    p = {"router": dense_init(gen, lead + shape, in_axis=len(lead),
                              dtype=dt)}
    for name in ("w_gate", "w_up", "w_down"):
        shape, dt = specs[name]
        bank = torch.empty(lead + shape, dtype=dt, device=gen.device)
        for idx in itertools.product(*(range(n) for n in lead)):
            bank[idx] = dense_init(gen, shape, in_axis=1, dtype=dt)
        p[name] = bank
    return p


def _capacity(group: int, top_k: int, E: int) -> int:
    return max(int(math.ceil(top_k * group * CAPACITY_FACTOR / E)), 1)


def _route(p, cfg, xt: torch.Tensor):
    """Router probabilities ``[..., E]`` (f32) of tokens ``xt [..., D]``,
    and the top-k gates renormalised to sum to 1 with their experts. The
    top k come from a stable descending sort, so equal probabilities go
    lower expert first, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order): a trained router's softmax underflows to exact
    zeros, and which zero-gated expert takes a capacity slot moves the
    later tokens' slots."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    gate_vals, expert_idx = top.values[..., :k], top.indices[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, expert_idx


def _experts(p, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its own rows: ``xe [E, R, D]`` ->
    ``[E, R, D]``, the gate's SiLU in f32 and cast back."""
    h = F.silu(torch.bmm(xe, p["w_gate"]).float()).to(xe.dtype)
    h = h * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"])


def moe_dropless(p, cfg, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless routing: every expert on every token, combined with the
    renormalised top-k gates. x [B, S, D] -> (y [B, S, D], aux)."""
    B, S, D = x.shape
    E, top_k = cfg.num_experts, cfg.num_experts_per_tok
    xt = sharded_reshape(x, (B * S, D))
    probs, gate_vals, expert_idx = _route(p, cfg, xt)
    gates = torch.zeros_like(probs).scatter(-1, expert_idx, gate_vals)
    ye = _experts(p, xt.expand((E,) + xt.shape))            # [E, T, D]
    y = torch.einsum("te,etd->td", gates.to(x.dtype), ye)

    frac_tokens = (gates > 0).float().mean(0)
    frac_probs = probs.mean(0)
    aux = E * (frac_tokens * frac_probs).sum() * top_k
    return sharded_reshape(y, (B, S, D)), aux


def moe_apply(p, cfg, x: torch.Tensor, *, group_size: int = 0,
              dropless: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar): the capacity
    dispatch over groups of ``group_size`` tokens (default
    :data:`DEFAULT_GROUP`; the largest divisor of B*S not above it), or,
    with ``dropless``, :func:`moe_dropless`."""
    if dropless:
        return moe_dropless(p, cfg, x)
    group_size = group_size or DEFAULT_GROUP
    B, S, D = x.shape
    E, top_k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    g = min(group_size, T)
    while T % g:
        g -= 1
    G = T // g
    C = _capacity(g, top_k, E)

    xt = sharded_reshape(x, (G, g, D))
    probs, gate_vals, expert_idx = _route(p, cfg, xt)       # [G, g, k]
    onehot = (expert_idx[..., None]
              == torch.arange(E, device=x.device)).float()  # [G, g, k, E]
    # slot of token t's k-th choice in its expert's queue, in token order
    pos_e = (onehot.reshape(G, g * top_k, E).cumsum(1)
             .reshape(G, g, top_k, E) - 1.0)
    pos = (pos_e * onehot).sum(-1)                          # [G, g, k]
    keep = (pos < C).float()
    slot_oh = ((pos.long()[..., None]
                == torch.arange(C, device=x.device)).float()
               * keep[..., None])                           # [G, g, k, C]
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot, slot_oh)
    combine = torch.einsum("gtke,gtkc->gtec", onehot * gate_vals[..., None],
                           slot_oh)
    dispatch = shard_hint(dispatch, ("expert_group", None, "expert", None))

    # each expert's C slots a group, gathered by the one-hot dispatch
    xe = torch.bmm(dispatch.to(x.dtype).reshape(G, g, E * C).transpose(1, 2),
                   xt)                                      # [G, E*C, D]
    xe = shard_hint(xe.reshape(G, E, C, D),
                    ("expert_group", "expert", None, None))
    ye = _experts(p, xe.transpose(0, 1).reshape(E, G * C, D))
    ye = shard_hint(ye.reshape(E, G, C, D).transpose(0, 1),
                    ("expert_group", "expert", None, None))
    y = torch.bmm(combine.to(x.dtype).reshape(G, g, E * C),
                  ye.reshape(G, E * C, D))

    # Switch load-balance loss: E * sum_e f_e * P_e
    if top_k == 1:
        frac_tokens = onehot[..., 0, :].mean((0, 1))
    else:
        frac_tokens = onehot.sum(2).mean((0, 1)) / top_k
    frac_probs = probs.mean((0, 1))
    aux = E * (frac_tokens * frac_probs).sum()
    return shard_hint(sharded_reshape(y, (B, S, D)),
                      ("batch", "seq", "embed")), aux
