"""A decoder-only mixture-of-experts LM in plain PyTorch, float32, as the
port runs ``granite-moe-1b-a400m``: token embedding; each layer RMSNorm,
grouped-query causal attention with half-split rotary embeddings, a
residual, RMSNorm, a top-k mixture of SwiGLU experts routed by capacity,
a residual; a final RMSNorm and the tied head. The loss is the mean
next-token cross-entropy plus ``router_aux_loss_coef`` times the
experts' load-balance loss summed over the layers.

The routing is the capacity dispatch of GShard and Switch as the port
forms it: tokens in groups of ``moe_group_size``; a token's experts are
its top-k router probabilities (a stable descending sort, so ties go to
the lower expert), their gates renormalised to sum to one; in a group,
expert e takes at most C = ceil(k * group * capacity_factor / E)
choices, in token order and then choice order, and a choice past C adds
nothing. The load-balance loss is E * sum_e f_e P_e, f_e the share of
the choices that name e and P_e the mean router probability of e.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with a per-tensor scale (the gradient passes straight
through), and every parameter kept in float8 e4m3 between steps, after
the attack and after the aggregation (where the port keeps bf16), the
rest as above. ``precision="bfloat16"`` rounds the same operands and
parameters to bfloat16: the port's precision, the probe of how far a
bfloat16 run parts from float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def param_specs(cfg: dict):
    """The port's parameter tree, ``(shape, dtype, std, kind)`` leaves:
    layers stacked on a leading axis, matrices in the model's dtype,
    norm scales and the router in float32."""
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    H, Hkv, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    E, Fd = cfg["num_local_experts"], cfg["intermediate_size"]
    bf, f32 = getattr(torch, cfg["dtype"]), torch.float32
    ones = ((L, D), f32, 0.0, "ones")
    layer = {
        "norm1": {"scale": ones}, "norm2": {"scale": ones},
        "attn": {"wq": ((L, D, H * dh), bf, D ** -0.5, "matrix"),
                 "wk": ((L, D, Hkv * dh), bf, D ** -0.5, "matrix"),
                 "wv": ((L, D, Hkv * dh), bf, D ** -0.5, "matrix"),
                 "wo": ((L, H * dh, D), bf, (H * dh) ** -0.5, "matrix")},
        "moe": {"router": ((L, D, E), f32, D ** -0.5, "matrix"),
                "w_gate": ((L, E, D, Fd), bf, D ** -0.5, "matrix"),
                "w_up": ((L, E, D, Fd), bf, D ** -0.5, "matrix"),
                "w_down": ((L, E, Fd, D), bf, Fd ** -0.5, "matrix")}}
    return {"embed": ((V, D), bf, 0.02, "matrix"),
            "final_norm": {"scale": ((D,), f32, 0.0, "ones")},
            "layers": {"slot_0": layer}}


def _fp8(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        q = x.detach().to(torch.bfloat16).float()
    return x + (q - x).detach()


ROUNDING = {"fp8": _fp8, "bfloat16": _bf16}


class MoELM:
    def __init__(self, cfg: dict, precision: str = "float32"):
        self.cfg = cfg
        self.round = ROUNDING.get(precision)

    def store(self, t):
        """How a parameter is kept between steps: float32, or rounded as
        ``precision`` says."""
        return self.round(t) if self.round else t

    def mm(self, a, b):
        if self.round:
            a, b = self.round(a), self.round(b)
        return a @ b

    def rms(self, scale, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.cfg["rms_norm_eps"]) * scale

    def rope(self, x, positions):
        half = x.shape[-1] // 2
        freqs = self.cfg["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = positions[:, None].float() * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, p, h):
        cfg = self.cfg
        B, S, _ = h.shape
        H, Hkv, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                      cfg["head_dim"])
        pos = torch.arange(S, device=h.device)
        q = self.rope(self.mm(h, p["wq"]).view(B, S, H, dh), pos)
        k = self.rope(self.mm(h, p["wk"]).view(B, S, Hkv, dh), pos)
        v = self.mm(h, p["wv"]).view(B, S, Hkv, dh)
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
        if self.round:
            q, k, v = self.round(q), self.round(k), self.round(v)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
        mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        if self.round:
            a = self.round(a)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, H * dh)
        return self.mm(o, p["wo"])

    def moe(self, p, h):
        cfg = self.cfg
        B, S, D = h.shape
        E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
        T = B * S
        g = min(cfg["moe_group_size"], T)
        while T % g:
            g -= 1
        cap = max(math.ceil(k * g * cfg["capacity_factor"] / E), 1)
        xt = h.reshape(T // g, g, D)
        probs = torch.softmax(self.mm(xt, p["router"]), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, experts = top.values[..., :k], top.indices[..., :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        onehot = F.one_hot(experts, E).float()               # [G, g, k, E]
        pos = (onehot.reshape(T // g, g * k, E).cumsum(1)
               .reshape(T // g, g, k, E) - 1.0)
        keep = (pos * onehot).sum(-1) < cap
        y = torch.zeros(T, D, device=h.device)
        flat_x = h.reshape(T, D)
        tok = torch.arange(T, device=h.device).reshape(T // g, g, 1).expand(
            -1, -1, k)
        for e in range(E):
            sel = (experts == e) & keep
            rows = tok[sel]
            if rows.numel() == 0:
                continue
            xe = flat_x[rows]
            he = F.silu(self.mm(xe, p["w_gate"][e])) * self.mm(xe,
                                                              p["w_up"][e])
            y = y.index_add(0, rows, self.mm(he, p["w_down"][e])
                            * gates[sel][:, None])
        frac_tokens = onehot.sum(2).mean((0, 1)) / k
        aux = E * (frac_tokens * probs.mean((0, 1))).sum()
        return y.reshape(B, S, D), aux

    def hidden(self, p, tokens):
        x = p["embed"][tokens.long()].float()
        stack = p["layers"]["slot_0"]
        aux = torch.zeros((), device=x.device)
        for i in range(self.cfg["num_hidden_layers"]):
            lp = {name: {k: v[i] for k, v in sub.items()}
                  for name, sub in stack.items()}
            x = x + self.attention(lp["attn"],
                                   self.rms(lp["norm1"]["scale"], x))
            y, a = self.moe(lp["moe"], self.rms(lp["norm2"]["scale"], x))
            x, aux = x + y, aux + a
        return self.rms(p["final_norm"]["scale"], x), aux

    def logits(self, p, tokens):
        h, aux = self.hidden(p, tokens)
        return self.mm(h, p["embed"].float().T), aux

    def eval_logits(self, p, tokens):
        return self.logits(p, tokens)[0]

    def loss(self, p, x, y):
        logits, aux = self.logits(p, x)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              y.reshape(-1).long())
        return nll + self.cfg["router_aux_loss_coef"] * aux

    def accuracy(self, p, x, y):
        """Share of the tokens whose first maximal logit is the label."""
        logits, _ = self.logits(p, x)
        return (logits.argmax(-1) == y.long()).float().mean()


def model(cfg: dict, precision: str = "float32") -> MoELM:
    return MoELM(cfg, precision)
