"""qwen2-0.5b [dense] — GQA, QKV bias. [arXiv:2407.10671]

Assigned: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        max_position=131_072,
        tie_embeddings=True,
        source="arXiv:2407.10671 (Qwen2), 0.5B size",
    )
