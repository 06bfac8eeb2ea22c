from .adamw import AdamWConfig, apply_update, global_norm, init_opt_state, lr_at

__all__ = ["AdamWConfig", "apply_update", "global_norm", "init_opt_state",
           "lr_at"]
