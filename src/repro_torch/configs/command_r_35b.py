"""command-r-35b [dense] — GQA, no-bias.

40L d_model=8192 64H (GQA kv=8) head_dim=128 d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified]. rope_theta=8M per HF config.
"""
from ..models.config import ModelConfig

ARCH_ID = "command-r-35b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=8192, vocab=256000,
        n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22528, act="swiglu", rope_theta=8e6,
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, n_heads=8,
                            n_kv_heads=2, head_dim=16, d_ff=128)
