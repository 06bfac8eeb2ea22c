"""mamba2-130m [ssm] — attention-free SSD (state-space duality).

24L d_model=768 d_inner=1536 heads=24 headdim=64 ssm_state=128 vocab=50280
[arXiv:2405.21060; unverified].
"""
from ..models.config import ModelConfig

ARCH_ID = "mamba2-130m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=24, d_model=768, vocab=50280,
        d_inner=1536, ssm_state=128, ssm_heads=24, ssm_groups=1,
        conv_kernel=4, ssm_chunk=128,
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, d_inner=128,
                            ssm_state=16, ssm_heads=4)
