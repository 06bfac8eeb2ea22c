"""yi-6b [dense] — llama-arch GQA.

32L d_model=4096 32H (GQA kv=4) head_dim=128 d_ff=11008 vocab=64000
[arXiv:2403.04652; hf]. rope_theta=5M per HF config.
"""
from ..models.config import ModelConfig

ARCH_ID = "yi-6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=4096, vocab=64000,
        n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008, act="swiglu", rope_theta=5e6,
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, n_heads=4,
                            n_kv_heads=2, head_dim=16, d_ff=128)
