"""whisper-base [audio] — enc-dec, conv frontend stubbed. [arXiv:2212.04356]

Assigned: 6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865.
The mel-spectrogram + conv feature extractor is a stub: the model takes
precomputed frame embeddings of shape (B, 1500, 512), which the serve
launcher draws with ``models.frontend_stub.stub_embeddings``.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        num_layers=6,               # decoder layers
        encoder_layers=6,
        encoder_seq=1500,           # 30 s of audio at 50 frames/s
        d_model=512,
        num_heads=8,
        num_kv_heads=8,             # MHA (GQA with kv = heads)
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        decoder_max_position=448,
        max_position=448,
        qkv_bias=True,              # biases on q, k and v, as the reference
        frontend="audio",
        norm_eps=1e-5,
        tie_embeddings=True,
        source="arXiv:2212.04356 (Whisper), base size",
    )
