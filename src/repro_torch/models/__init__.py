from .config import ModelConfig
from .model import (backbone, decode_step, embed_tokens, init_cache,
                    init_params, loss_fn, padded_vocab, param_specs, prefill,
                    token_loss)

__all__ = ["ModelConfig", "backbone", "decode_step", "embed_tokens",
           "init_cache", "init_params", "loss_fn", "padded_vocab",
           "param_specs", "prefill", "token_loss"]
