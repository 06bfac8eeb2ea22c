from .adamw import AdamWConfig, apply_update, global_norm, init_opt_state, lr_at
from .compression import (compressed_psum, dequantize_int8,
                          init_error_feedback, quantize_int8)

__all__ = ["AdamWConfig", "apply_update", "global_norm", "init_opt_state",
           "lr_at", "compressed_psum", "dequantize_int8",
           "init_error_feedback", "quantize_int8"]
