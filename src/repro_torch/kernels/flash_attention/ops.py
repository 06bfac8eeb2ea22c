"""The flash attention kernel, bound to PyTorch: build, launch, count.

``flash_attention`` is the entry point, with the JAX package's signature.
For tensors on the CPU it runs the plain version (``ref.flash_attention_ref``);
for tensors on a CUDA device it launches ``csrc/flash_attention.cu``, or
raises: bf16 inputs go to the wgmma kernel fed by TMA (tiles in
``tile_plan``), f32 inputs to the one that runs each product as three TF32
products on ``mma.sync`` (3xTF32, f32-accurate; tiles in
``f32_tile_plan``), each at the (D, Dv) pairs of ``HEAD_DIMS``. It never
falls back from a kernel to the plain version or from one kernel to the
other.
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
# the (D, Dv) pairs the kernels take: q's and k's head dim, v's; gemma-2b's
# (256, 256) and minicpm3-4b's MLA (96, 64) beside the dense models' (the
# C side's FA_PAIRS)
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (96, 64))
SMEM_MAX = 232_448    # the dynamic shared memory an H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None   # the loaded library, once per process


def _check_pair(d: int, dv: int) -> None:
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"the kernels take head dims (D, Dv) in "
                         f"{HEAD_DIMS}, not {(d, dv)}")


def tile_plan(d: int, dv: int) -> dict:
    """The bf16 kernel's plan at head dims ``(d, dv)``, as ``csrc`` fixes
    it (``fa_bf16_plan`` there): query rows a block (two consumer
    warpgroups of 64 and a producer) and keys a KV tile (80 at D 256, else
    128); the swizzled row of one TMA box; the columns Q and K take in
    shared memory (whole boxes: 128 at D 96, its last 32 zero); ring
    stages, as many as fit (at most 4); ``split`` (at D 256): K and V on
    rings of their own, as many stages each, the consumers taking turns to
    issue their products, else one ring of K and V tiles; and the dynamic
    shared memory a block takes (Q, the ring, one 8-byte "full" and one
    "empty" mbarrier a stage of each ring plus Q's, and 1024 bytes to align
    the base)."""
    _check_pair(d, dv)
    split = d == 256
    rings = 2 if split else 1
    q_rows, kv_rows = 128, 80 if split else 128
    row_bytes = 64 if d == 32 else 128
    box_cols = row_bytes // 2
    qk_cols = -(-d // box_cols) * box_cols
    q_bytes = q_rows * qk_cols * 2
    stage = kv_rows * (qk_cols + dv) * 2
    stages = min(4, (SMEM_MAX - 1024 - 8 - q_bytes) // (stage + 16 * rings))
    return {"q_rows": q_rows, "kv_rows": kv_rows, "k_stages": stages,
            "v_stages": stages, "split": split, "consumers": 2,
            "consumer_rows": 64, "box_row_bytes": row_bytes,
            "qk_cols": qk_cols,
            "smem_bytes": q_bytes + stages * stage
            + 8 * (2 * rings * stages + 1) + 1024}


def f32_tile_plan(d: int, dv: int) -> dict:
    """The f32 kernel's plan at head dims ``(d, dv)``, as ``csrc`` fixes it
    (``fa_f32_plan`` there). Every pair but (256, 256) splits once
    (``split_once``): 128 query rows in 8 warps of 16, K and V of each KV
    tile split into tf32 hi and lo once a block into one split stage of
    fragment-ordered planes, from one raw stage, and Q split once into
    planes; keys a tile: 128 at d 32, 64 at d 64 and 96, 32 at d 128. At
    (256, 256), the pair plan: 64 rows in 8 warps, ``strip_warps`` 2 a
    16-row strip (each scoring half a 32-key tile's keys and holding half
    of O's columns), Q raw and K and V raw in a ring of 2 raw stages,
    each warp's half of P and its row maxima exchanged in shared memory. Raw
    rows are padded to strides (floats) of d + 16 and dv + 4;
    ``column_blocks``: blocks of 16 columns of S whose products are in
    flight at once. The dynamic shared memory a block takes: Q's planes
    (or its raw tile), the split and raw stages, and the pair plan's
    exchange."""
    _check_pair(d, dv)
    once = d != 256
    q_rows, strip_warps = (128, 1) if once else (64, 2)
    kv_rows = {32: 128, 64: 64, 96: 64}.get(d, 32)
    raw, split = (1, 1) if once else (2, 0)
    warps = q_rows // 16 * strip_warps
    qk_stride, v_stride = d + 16, dv + 4
    raw_words = raw * kv_rows * (qk_stride + v_stride)
    if once:
        words = 2 * q_rows * d + split * 2 * kv_rows * (d + dv) + raw_words
    else:
        words = q_rows * qk_stride + raw_words \
            + warps * (kv_rows // 16 * 128 + 64)
    return {"q_rows": q_rows, "kv_rows": kv_rows,
            "strip_warps": strip_warps, "warps": warps,
            "raw_stages": raw, "split_stages": split, "split_once": once,
            "qk_stride": qk_stride, "v_stride": v_stride,
            "column_blocks": 4 if d == 128 else 2,
            "smem_bytes": 4 * words}


def kernel_window(window: Optional[int], S: int) -> int:
    """The window as the kernels take it: keys with query - key >= window
    are masked, so S stands for no window; a window below 1 (the
    reference's rows of -1e30, averaged uniformly where no key is left)
    passes as itself, cut to [-S, S], where every value masks as it
    would."""
    return S if window is None else max(-S, min(window, S))


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_all({"flash_attention": SOURCE})
                          ["flash_attention"])
        lib.fa_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fa_launch.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        for plan in (lib.fa_bf16_plan, lib.fa_f32_plan):
            plan.argtypes = [ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)]
            plan.restype = ctypes.c_int
        _lib = lib
    return _lib


def built_tile_plan(d: int, dv: int) -> dict:
    """The bf16 plan as a built library reports it (``fa_bf16_plan``), in
    ``tile_plan``'s keys: what ``tile_plan`` mirrors."""
    _check_pair(d, dv)
    out = (ctypes.c_int * 5)()
    if load_library().fa_bf16_plan(d, dv, out):
        raise ValueError(f"the library has no bf16 plan for {(d, dv)}")
    q_rows, kv_rows, stages, split, smem = out
    return {"q_rows": q_rows, "kv_rows": kv_rows, "k_stages": stages,
            "v_stages": stages, "split": bool(split), "smem_bytes": smem}


def built_f32_tile_plan(d: int, dv: int) -> dict:
    """The f32 plan as a built library reports it (``fa_f32_plan``), in
    ``f32_tile_plan``'s keys: what ``f32_tile_plan`` mirrors."""
    _check_pair(d, dv)
    out = (ctypes.c_int * 10)()
    if load_library().fa_f32_plan(d, dv, out):
        raise ValueError(f"the library has no f32 plan for {(d, dv)}")
    rows, keys, strip_warps, raw, split, once, qk, v, blocks, smem = out
    return {"q_rows": rows, "kv_rows": keys, "strip_warps": strip_warps,
            "raw_stages": raw, "split_stages": split,
            "split_once": bool(once), "qk_stride": qk, "v_stride": v,
            "column_blocks": blocks, "smem_bytes": smem}


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


def _refusal(q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernels do not take q, k and v's head dims or dtypes,
    or None where they do."""
    pair = (q.shape[-1], v.shape[-1])
    if pair not in HEAD_DIMS or k.shape[-1] != q.shape[-1]:
        return (f"the kernels take head dims (D, Dv) in {HEAD_DIMS}, not "
                f"{pair}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        return ("the kernel takes q, k, v all f32 or all bf16, not "
                f"{q.dtype}, {k.dtype}, {v.dtype}")
    return None


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the CUDA kernels take q, k and v's dtypes and head dims (q's
    and k's D, v's Dv): ``check_kernel_inputs`` as a predicate, alignment
    aside (the launch makes the tensors contiguous, and a copy is
    aligned)."""
    return _refusal(q, k, v) is None


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take: head dims (q's and k's
    D, v's Dv) outside ``HEAD_DIMS``, dtypes, and for bf16 (TMA) a data
    pointer off a 16-byte boundary. Takes tensors already made
    contiguous."""
    why = _refusal(q, k, v)
    if why is not None:
        raise ValueError(why)
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
    ignores them, and the kernels take their own tiles (``tile_plan``,
    ``f32_tile_plan``; any S, ragged edges masked). The kernels take f32
    or bf16 at the (D, Dv) pairs of ``HEAD_DIMS``
    (``check_kernel_inputs``), and any window (``kernel_window``)."""
    del q_block, kv_block
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    B, Hq, S, D = q.shape
    Dv = v.shape[-1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_kernel_inputs(q, k, v)
    lib = load_library()
    out = q.new_empty((B, Hq, S, Dv))
    scale = scale if scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], B, Hq, k.shape[1],
                        S, D, Dv, scale, int(causal),
                        kernel_window(window, S), stream)
    if err:
        raise RuntimeError("flash attention kernel launch failed: "
                           f"{lib.fa_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
reference = flash_attention_ref
