"""The SSD scan kernel, bound to PyTorch: build, launch, count.

``ssd`` is the entry point, with the JAX package's signature. For tensors
on the CPU it runs the plain chunked scan (``models.ssm.ssd_chunked``, at
the same chunk); for tensors on a CUDA device it launches
``csrc/ssd_scan.cu``, or raises. It never falls back from the kernel to the
plain version. ``ssd.launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..build import build_all
from .ref import ssd_chunked_ref, ssd_reference

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "ssd_scan.cu")
P_TILE = 16                  # state rows per block (see the source's note)
MAX_SMEM_BYTES = 232_448     # the H100's opt-in shared memory per block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None   # the loaded library, once per process


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_all({"ssd_scan": SOURCE})["ssd_scan"])
        lib.ssd_launch.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.ssd_launch.restype = ctypes.c_int
        lib.ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_smem_bytes.restype = ctypes.c_int
        lib.ssd_max_chunk.argtypes = []
        lib.ssd_max_chunk.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, dt, A, Bc, Cc, D) -> None:
    if x.dim() != 4 or Bc.dim() != 4 or Cc.shape != Bc.shape:
        raise ValueError("x: (B, S, H, P); Bc and Cc: (B, S, G, N)")
    B, S, H, P = x.shape
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) or \
            tuple(D.shape) != (H,) or tuple(Bc.shape[:2]) != (B, S):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"D {tuple(D.shape)}, Bc {tuple(Bc.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if H % Bc.shape[2]:
        raise ValueError(f"{H} heads do not group over {Bc.shape[2]} groups")
    if len({t.device for t in (x, dt, A, Bc, Cc, D)}) > 1:
        raise ValueError("the inputs lie on different devices")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
        Cc: torch.Tensor, D: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H) (post-softplus, read as f32); A: (H,)
    (negative); Bc/Cc: (B,S,G,N); D: (H,). Returns (y (B,S,H,P) in x's
    dtype, h (B,H,P,N) f32).

    ``chunk`` is halved until it divides S, as in the JAX kernel. The
    kernel computes in chunks of at most 128 steps (fewer where a large N
    would overflow shared memory); the function does not depend on it."""
    _check(x, dt, A, Bc, Cc, D)
    B, S, H, P = x.shape
    G, N = Bc.shape[2], Bc.shape[3]
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bc, Cc, D, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan kernel for device {x.device}")
    if x.dtype not in _DTYPES or Bc.dtype != x.dtype or Cc.dtype != x.dtype:
        raise ValueError("the kernel takes x, Bc, Cc all f32 or all bf16, "
                         f"not {x.dtype}, {Bc.dtype}, {Cc.dtype}")
    lib = load_library()
    pt = min(P, P_TILE)
    q = min(chunk, lib.ssd_max_chunk())
    while q > 1 and lib.ssd_smem_bytes(q, N, pt) > MAX_SMEM_BYTES:
        q //= 2
    x, Bc, Cc = x.contiguous(), Bc.contiguous(), Cc.contiguous()
    dtf = dt.float().contiguous()
    Af, Df = A.float().contiguous(), D.float().contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_launch(x.data_ptr(), dtf.data_ptr(), Af.data_ptr(),
                         Bc.data_ptr(), Cc.data_ptr(), Df.data_ptr(),
                         y.data_ptr(), h.data_ptr(), _DTYPES[x.dtype], B, S,
                         H, P, G, N, q, pt, stream)
    if err:
        raise RuntimeError("SSD scan kernel launch failed: "
                           f"{lib.ssd_error_string(err).decode()}")
    ssd.launches += 1
    return y, h


ssd.launches = 0
reference = ssd_reference
