"""The flash attention kernel, bound to PyTorch: build, launch, count.

``flash_attention`` is the entry point, with the JAX package's signature.
For tensors on the CPU it runs the plain version (``ref.flash_attention_ref``);
for tensors on a CUDA device it launches ``csrc/flash_attention.cu``, or
raises. It never falls back from the kernel to the plain version.
``flash_attention.launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..build import build_all
from .ref import flash_attention_ref

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_attention.cu")
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None   # the loaded library, once per process


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_all({"flash_attention": SOURCE})
                          ["flash_attention"])
        lib.fa_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fa_launch.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q: (B, Hq, S, D); k and v: (B, KVH, S, D)")
    B, Hq, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, length or head dim")
    if Hq % k.shape[1]:
        raise ValueError(f"{Hq} query heads do not group over "
                         f"{k.shape[1]} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"window {window} masks every key")
    if len({q.device, k.device, v.device}) > 1:
        raise ValueError("q, k and v lie on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_block: int = 512,
                    kv_block: int = 512) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, KVH, S, D) -> (B, Hq, S, D) in q's dtype.

    ``q_block`` and ``kv_block`` keep the JAX signature: the plain path
    ignores them, and the kernel takes its own 64 x 64 tiles (any S, ragged
    edges masked). The kernel takes f32 or bf16, D in {32, 64, 128}."""
    del q_block, kv_block
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    B, Hq, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the kernel takes q, k, v all f32 or all bf16, not "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    lib = load_library()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], B, Hq, k.shape[1],
                        S, D, scale, int(causal), window or 0, stream)
    if err:
        raise RuntimeError("flash attention kernel launch failed: "
                           f"{lib.fa_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
reference = flash_attention_ref
