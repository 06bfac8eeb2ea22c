"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1), tied embeddings.

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000 [arXiv:2403.08295; hf].
"""
from ..models.config import ModelConfig

ARCH_ID = "gemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=18, d_model=2048, vocab=256000,
        n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, act="geglu",
        tie_embeddings=True, embed_scale=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, n_heads=4,
                            n_kv_heads=1, head_dim=16, d_ff=128)
