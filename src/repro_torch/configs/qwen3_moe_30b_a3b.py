"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]

Assigned: 48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert)
vocab=151936, MoE 128e top-8, qk_norm.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,                   # per-expert FFN width
        vocab_size=151936,
        num_experts=128,
        num_experts_per_tok=8,
        moe_every=1,
        qk_norm=True,
        rope_theta=1_000_000.0,
        max_position=131_072,
        source="hf:Qwen/Qwen3-30B-A3B model card",
    )
