"""qwen2-72b [dense] — GQA, QKV bias. [arXiv:2407.10671]

Assigned: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        max_position=131_072,
        source="arXiv:2407.10671 (Qwen2), 72B size",
    )
