"""musicgen-medium [audio] — decoder-only LM over EnCodec tokens.

48L d_model=1536 24H (kv=24, MHA) head_dim=64 d_ff=6144 vocab=2048
[arXiv:2306.05284; hf]. The EnCodec frontend is a STUB: the backbone
consumes token ids directly (codebook interleaving is a frontend concern);
positional scheme mapped to RoPE (orthogonal to all experiments here —
see DESIGN.md).
"""
from ..models.config import ModelConfig

ARCH_ID = "musicgen-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=48, d_model=1536, vocab=2048,
        n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, act="swiglu",
        frontend="audio",
    )


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, vocab=199, n_heads=4,
                            n_kv_heads=4, head_dim=16, d_ff=128)
