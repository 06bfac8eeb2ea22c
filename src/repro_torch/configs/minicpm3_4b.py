"""minicpm3-4b [dense] — MLA (multi-head latent attention).

62L d_model=2560 40H d_ff=6400 vocab=73448 [hf:openbmb/MiniCPM3-4B; hf].
MLA dims from the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope=64, qk_rope=32, v_head=64. The assignment's "kv=40" reflects the
MHA-equivalent head count; MLA caches the 256+32 latent instead.
"""
from ..models.config import ModelConfig

ARCH_ID = "minicpm3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="mla",
        n_layers=62, d_model=2560, vocab=73448,
        n_heads=40, n_kv_heads=40, head_dim=64,
        q_lora_rank=768, kv_lora_rank=256,
        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
        d_ff=6400, act="swiglu",
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, n_heads=4,
                            n_kv_heads=4, head_dim=16, q_lora_rank=32,
                            kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                            v_head_dim=16, d_ff=128)
