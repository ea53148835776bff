"""qwen1.5-110b [dense] — QKV bias. [hf:Qwen/Qwen1.5 family card]

Assigned: 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        max_position=32_768,
        source="hf:Qwen/Qwen1.5-110B model card",
    )
