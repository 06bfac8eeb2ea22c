"""Carry the JAX package's parameters into the port, bit for bit.

The JAX package draws its weights with ``jax.random``, which torch cannot
reproduce; a test that holds the two packages against each other therefore
draws them once in JAX, converts the arrays to numpy and hands them here.
bf16 arrives as an ml_dtypes array and crosses through its 16-bit pattern,
so this module needs neither jax nor ml_dtypes.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        t = torch.from_numpy(np.array(a, copy=True).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(np_tree: Any, device) -> Any:
    """Nested dict of numpy arrays (the JAX params after ``np.asarray``) ->
    the same dict of torch tensors on ``device``."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    return tensor_from_numpy(np_tree, device)
