"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) head_dim=128 expert d_ff=14336 vocab=32000
window=4096 [arXiv:2401.04088; hf].
"""
from ..models.config import ModelConfig

ARCH_ID = "mixtral-8x7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=32, d_model=4096, vocab=32000,
        n_heads=32, n_kv_heads=8, head_dim=128,
        n_experts=8, top_k=2, d_ff_expert=14336, d_ff=0,
        window=4096, rope_theta=1e6, act="swiglu",
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, n_heads=4,
                            n_kv_heads=2, head_dim=16, n_experts=4, top_k=2,
                            d_ff_expert=64, window=16)
