"""Carry trees between the JAX package and the port, bit for bit.

The JAX package draws its weights with ``jax.random``, which torch cannot
reproduce; a test that holds the two packages against each other therefore
draws them once in JAX, converts the arrays to numpy and hands them here
(``params_from_jax``, for any nested dict: params or optimizer state). The
reverse, ``tree_to_numpy``, gives numpy trees that the JAX package takes.
bf16 crosses through its 16-bit pattern, so this module needs neither jax
nor ml_dtypes: numpy's bf16 type is the caller's to name.
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


def tensor_to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """A host copy of ``t``. bf16 comes back as its 16-bit pattern, viewed
    as ``bf16_dtype`` when one is given (e.g. ``ml_dtypes.bfloat16``), else
    as uint16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        a = t.view(torch.int16).numpy().view(np.uint16).copy()
        return a.view(bf16_dtype) if bf16_dtype is not None else a
    return t.numpy().copy()


def tree_to_numpy(tree: Any, bf16_dtype=None) -> Any:
    """Nested dict of tensors -> the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v, bf16_dtype) for k, v in tree.items()}
    return tensor_to_numpy(tree, bf16_dtype)
