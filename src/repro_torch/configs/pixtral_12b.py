"""pixtral-12b [vlm] — Pixtral-ViT frontend (STUB) + Mistral-Nemo backbone.

40L d_model=5120 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]. The vision frontend supplies
precomputed patch embeddings via ``prefix_embeds`` per the assignment.
"""
from ..models.config import ModelConfig

ARCH_ID = "pixtral-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=5120, vocab=131072,
        n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, act="swiglu", rope_theta=1e6,
        frontend="vision", n_prefix_embeds=256,
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, n_heads=4,
                            n_kv_heads=2, head_dim=16, d_ff=128,
                            n_prefix_embeds=4)
