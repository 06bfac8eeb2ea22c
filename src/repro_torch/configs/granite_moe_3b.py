"""granite-moe-3b-a800m [moe] — 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) head_dim=64 expert d_ff=512 vocab=49155
[hf:ibm-granite/granite-3.0-*-base family; hf].
"""
from ..models.config import ModelConfig

ARCH_ID = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=32, d_model=1536, vocab=49155,
        n_heads=24, n_kv_heads=8, head_dim=64,
        n_experts=40, top_k=8, d_ff_expert=512, d_ff=0,
        act="swiglu",
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, n_heads=4,
                            n_kv_heads=2, head_dim=16, n_experts=8, top_k=2,
                            d_ff_expert=32)
