"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]

Assigned: 64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=256,
        ssm_ngroups=1,
        norm_eps=1e-5,
        tie_embeddings=True,
        source="arXiv:2405.21060 (Mamba2), 2.7B size",
    )
