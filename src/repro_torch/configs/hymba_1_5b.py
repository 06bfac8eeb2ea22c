"""hymba-1.5b [hybrid] — parallel attention + mamba heads per block.

32L d_model=1600 25H (GQA kv=5) head_dim=64 d_ff=5504 vocab=32001
ssm_state=16 [arXiv:2411.13676; hf]. SWA window=2048 on the attention path
(the paper's global-attention layers and meta tokens are omitted — see
DESIGN.md); SSD heads: d_inner=1600, 25 heads, headdim 64.
"""
from ..models.config import ModelConfig

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=32, d_model=1600, vocab=32001,
        n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, act="swiglu", window=2048,
        d_inner=1600, ssm_state=16, ssm_heads=25, ssm_groups=1,
        conv_kernel=4, ssm_chunk=128,
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, n_heads=5,
                            n_kv_heads=1, head_dim=16, d_ff=128, window=16,
                            d_inner=80, ssm_state=8, ssm_heads=5)
