"""granite-moe-1b-a400m [moe] — 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]

Assigned: 24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert)
vocab=49155, MoE 32e top-8.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,                   # per-expert FFN width
        vocab_size=49155,
        num_experts=32,
        num_experts_per_tok=8,
        moe_every=1,
        rope_theta=10_000.0,
        max_position=4_096,
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base model card",
    )
