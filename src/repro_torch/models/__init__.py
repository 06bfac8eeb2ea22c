from .config import ModelConfig
from .model import (decode_step, embed_tokens, init_cache, init_params,
                    padded_vocab, prefill)

__all__ = ["ModelConfig", "decode_step", "embed_tokens", "init_cache",
           "init_params", "padded_vocab", "prefill"]
