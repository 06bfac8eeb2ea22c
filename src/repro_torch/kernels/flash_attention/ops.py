"""The flash attention kernel, bound to PyTorch: build, launch, count.

``flash_attention`` is the entry point, with the JAX package's signature.
For tensors on the CPU it runs the plain version (``ref.flash_attention_ref``);
for tensors on a CUDA device it launches ``csrc/flash_attention.cu``, or
raises: bf16 inputs go to the wgmma kernel fed by TMA (tiles in
``tile_plan``), f32 inputs to the one that runs each product as three TF32
products on ``mma.sync`` (3xTF32, f32-accurate; tiles in
``f32_tile_plan``). It never falls back
from a kernel to the plain version or from one kernel to the other.
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


def tile_plan(d: int) -> dict:
    """The bf16 kernel's tiles at head dim ``d``, as ``csrc`` fixes them:
    query rows and keys a block, ring stages, the swizzled row of one TMA
    box, and the dynamic shared memory a block takes (Q, the ring of K and
    V tiles, one 8-byte mbarrier per ring slot twice plus Q's, and 1024
    bytes to align the base)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {d}")
    q_rows = kv_rows = 128
    stages = 3 if d == 128 else 4
    row_bytes = 64 if d == 32 else 128
    tiles = q_rows * d * 2 + stages * 2 * kv_rows * d * 2
    return {"q_rows": q_rows, "kv_rows": kv_rows, "stages": stages,
            "box_row_bytes": row_bytes, "consumer_rows": 64,
            "smem_bytes": tiles + 8 * (2 * stages + 1) + 1024}


def f32_tile_plan(d: int) -> dict:
    """The f32 kernel's tiles at head dim ``d``, as ``csrc`` fixes them:
    query rows a block (8 warps of 16), keys a KV tile, ring stages, the
    row strides in floats of Q and K (d + 16) and of V (d + 4), and the
    dynamic shared memory a block takes (Q, and the ring of K and V
    tiles)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {d}")
    q_rows, kv_rows, stages = 128, 64, 2
    qk_stride, v_stride = d + 16, d + 4
    floats = q_rows * qk_stride + stages * kv_rows * (qk_stride + v_stride)
    return {"q_rows": q_rows, "kv_rows": kv_rows, "stages": stages,
            "warps": q_rows // 16, "qk_stride": qk_stride,
            "v_stride": v_stride, "smem_bytes": 4 * floats}


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
        for fn in (lib.fa_bf16_smem_bytes, lib.fa_f32_smem_bytes):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError("q: (B, Hq, S, D); k: (B, KVH, S, D); "
                         "v: (B, KVH, S, Dv)")
    B, Hq, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, length or head dim")
    if Hq % k.shape[1]:
        raise ValueError(f"{Hq} query heads do not group over "
                         f"{k.shape[1]} KV heads")
    if len({q.device, k.device, v.device}) > 1:
        raise ValueError("q, k and v lie on different devices")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None) -> None:
    """Raise on what the CUDA kernels do not take: a V head dim unlike
    q's and k's, head dims outside ``HEAD_DIMS``, a window below 1 (the
    plain version then averages every key uniformly, as the reference
    does; the kernels read a window <= 0 as none), dtypes, and for bf16
    (TMA) a data pointer off a 16-byte boundary. Takes tensors already
    made contiguous."""
    D = q.shape[-1]
    if v.shape[-1] != D:
        raise ValueError(f"the kernel takes v's head dim equal to q's and "
                         f"k's: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {D} "
                         f"(q {tuple(q.shape)})")
    if window is not None and window < 1:
        raise ValueError(f"the kernel takes a window of at least 1, not "
                         f"{window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the kernel takes q, k, v all f32 or all bf16, not "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}'s data is not 16-byte aligned, "
                                 "which the bf16 kernel's TMA loads need")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_block: int = 512,
                    kv_block: int = 512) -> torch.Tensor:
    """q: (B, Hq, S, D); k: (B, KVH, S, D); v: (B, KVH, S, Dv) -> (B, Hq,
    S, Dv) in q's dtype.

    ``q_block`` and ``kv_block`` keep the JAX signature: the plain path
    ignores them, and the kernels take their own tiles (bf16: 128 x 128,
    ``tile_plan``; f32: 128 x 64, ``f32_tile_plan``; any S, ragged edges
    masked). The kernels
    take f32 or bf16, Dv = D in {32, 64, 128}, and a window of at least 1
    (``check_kernel_inputs``)."""
    del q_block, kv_block
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    B, Hq, S, D = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_kernel_inputs(q, k, v, window)
    lib = load_library()
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
