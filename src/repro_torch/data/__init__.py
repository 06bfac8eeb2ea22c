from .pipeline import SyntheticTokens, make_batch, make_global_batch

__all__ = ["SyntheticTokens", "make_batch", "make_global_batch"]
