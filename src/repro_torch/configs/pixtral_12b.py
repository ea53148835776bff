"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo decoder. [hf:mistralai/Pixtral-12B-2409]

Assigned: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
The ViT vision encoder + projector is a stub: the model takes precomputed
patch embeddings (B, num_patches, d_model), projected by ``patch_proj`` and
placed before the text, which the serve launcher draws with
``models.frontend_stub.stub_embeddings``.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        num_patches=1024,           # one 1024-patch image per sample
        frontend="vision",
        rope_theta=1_000_000.0,
        max_position=131_072,
        source="hf:mistralai/Pixtral-12B-2409 model card",
    )
