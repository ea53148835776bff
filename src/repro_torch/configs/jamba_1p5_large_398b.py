"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE. [arXiv:2403.19887]

Assigned: 72L d_model=8192 64H (GQA kv=8) d_ff=24576 (per expert),
vocab=65536, MoE 16e top-2. One attention layer per 8-layer period
(the remaining 7 are Mamba); MoE FFN every other layer.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,                 # per-expert FFN width
        vocab_size=65536,
        num_experts=16,
        num_experts_per_tok=2,
        moe_every=2,
        moe_offset=1,
        attn_every=8,               # 1:7 attention:mamba interleave
        attn_offset=4,              # attention sits mid-period (Jamba layout)
        ssm_state=16,               # Jamba uses small-state Mamba layers
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=256,
        rope_theta=1_000_000.0,
        max_position=262_144,
        norm_eps=1e-5,
        source="arXiv:2403.19887 + Jamba-1.5 card (398B total params)",
    )
