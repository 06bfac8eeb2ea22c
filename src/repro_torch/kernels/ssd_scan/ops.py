"""The SSD scan kernel, bound to PyTorch: build, launch, count.

``ssd`` is the entry point, with the JAX package's signature. For tensors
on the CPU it runs the plain chunked scan (``models.ssm.ssd_chunked``, at
the same chunk); for tensors on a CUDA device it runs ``csrc/ssd_scan.cu``
in its three phases (chunk state, state passing, chunk scan: three CUDA
kernels on the current stream, into scratch allocated here), or raises. It
never falls back from the kernel to the plain version. ``ssd.launches``
counts calls of ``ssd`` that reached the card (one per call, whatever the
number of CUDA kernels the call issues), and nothing else;
``ssd.kernel_launches`` counts the CUDA kernels themselves, by phase, each
where it is launched.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, List, Optional, Tuple

import torch

from ..build import build_all
from .ref import ssd_chunked_ref, ssd_reference

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "ssd_scan.cu")
MAX_CHUNK = 128              # the kernels' longest chunk (csrc: kQMax)
MAX_SMEM_BYTES = 232_448     # the H100's opt-in shared memory per block
SMS = 132                    # the H100's streaming multiprocessors
MAX_GROUPS = 4               # warp groups a bf16 chunk-scan block may hold
F32_PASS = 64                # head-dim columns an f32 chunk-scan item covers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None   # the loaded library, once per process


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _kmajor(n: int) -> int:
    """Row stride (floats) of an f32 tile read along its rows (csrc:
    f32::kmajor_stride)."""
    s = _up(n, 16)
    return s + 16 if s % 32 == 0 else s


def _nmajor(n: int) -> int:
    """Row stride (floats) of an f32 tile read down its columns (csrc:
    f32::nmajor_stride)."""
    return _up(n, 16) + 4


def _f32_scan_bytes(q: int, n: int) -> int:
    # C.B^T fragments, C, a region for B and then x's hi and rest planes,
    # h_in, dt twice and L
    qk = _up(q, 16)
    nst, cst = qk // 16, _kmajor(n)
    region = max(qk * cst, 2 * qk * _nmajor(F32_PASS))
    return 512 * nst * (nst + 1) + 4 * (qk * cst + region + F32_PASS * cst
                                        + 3 * qk)


def smem_bytes(phase: int, dtype: torch.dtype, q: int, n: int, p: int,
               groups: int = 1) -> int:
    """Dynamic shared memory of a block of phase 1 (chunk state) or 3
    (chunk scan, with ``groups`` warp groups in bf16) at chunk ``q``, state
    ``n``, head dim ``p``, as ``csrc`` lays it out (``ssd_smem_bytes``
    there)."""
    if phase not in (1, 3):
        raise ValueError(f"phase {phase} takes no shared memory")
    if dtype == torch.float32:
        if phase == 1:     # x and B, or the warps' partial sums; L, dt, w
            qk = _up(q, 16)
            tiles = -(-p // 32) * -(-n // 32)
            parts = 8 * 32 * 32 if tiles <= 4 else 0
            return 4 * (max(qk * (_nmajor(p) + _nmajor(n)), parts) + 3 * qk)
        return _f32_scan_bytes(q, n)
    qk, nk, pk = _up(q, 16), _up(n, 16), _up(p, 16)
    if phase == 1:         # L, dt, w; (x w)'s three terms, B (bf16)
        return 12 * qk + 2 * qk * (3 * (pk + 8) + nk + 8)
    # C.B^T fragments, C, then B or each group's L, dt, x, h_in's terms
    nst = qk // 16
    c_bytes = 2 * qk * (nk + 8)
    group = 8 * qk + 2 * qk * (pk + 8) + 6 * pk * (nk + 8)
    return 512 * nst * (nst + 1) + c_bytes + max(c_bytes, groups * group)


@functools.lru_cache(maxsize=256)
def tile_plan(B: int, S: int, H: int, P: int, G: int, N: int,
              dtype: torch.dtype, chunk: int = MAX_CHUNK) -> dict:
    """How ``ssd`` runs the kernels at these shapes: the chunk the kernels
    cut at (``chunk``, at most 128, halved while a block's shared memory
    would not fit), the number of chunks, the heads a chunk-scan block owns
    (it computes C.B^T once for them: more heads, fewer products; fewer,
    more blocks in flight) and, in bf16, the warp groups that work on them
    side by side, each on its own head (as many as fit, up to 4; an f32
    block is 16 warps on one head at a time). A block holds many warps, so
    the plan aims at one block per SM. Also each phase's shared memory and
    the scratch bytes (the chunks' states and decays, f32). Raises if no
    chunk fits. Cached: do not modify the dict it returns."""
    q = min(chunk, MAX_CHUNK)
    while max(smem_bytes(ph, dtype, q, N, P) for ph in (1, 3)) \
            > MAX_SMEM_BYTES:
        if q == 1:
            raise ValueError(f"the SSD kernel's shared memory cannot hold "
                             f"a state of P {P} x N {N} in {dtype}")
        q //= 2
    nc = -(-S // q)
    hpg = H // G
    pairs = B * nc * G            # (batch, chunk, group): C.B^T's
    slices = min(hpg, max(1, SMS // pairs))
    heads = -(-hpg // slices)
    groups = 1
    if dtype != torch.float32:
        groups = max(g for g in range(1, min(MAX_GROUPS, heads) + 1)
                     if smem_bytes(3, dtype, q, N, P, g) <= MAX_SMEM_BYTES)
    return {"chunk": q, "chunks": nc, "heads_per_block": heads,
            "groups": groups, "scan_blocks": pairs * -(-hpg // heads),
            "smem_bytes": {1: smem_bytes(1, dtype, q, N, P),
                           3: smem_bytes(3, dtype, q, N, P, groups)},
            "scratch_bytes": 4 * B * nc * H * (P * N + 1)}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_all({"ssd_scan": SOURCE})["ssd_scan"])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ssd_chunk_state_launch.argtypes = [vp] * 6 + [ci] * 8 + [vp]
        lib.ssd_state_pass_launch.argtypes = [vp] * 3 + [ci] * 5 + [vp]
        lib.ssd_chunk_scan_launch.argtypes = [vp] * 8 + [ci] * 10 + [vp]
        for fn in (lib.ssd_chunk_state_launch, lib.ssd_state_pass_launch,
                   lib.ssd_chunk_scan_launch):
            fn.restype = ci
        lib.ssd_smem_bytes.argtypes = [ci] * 6
        lib.ssd_smem_bytes.restype = ci
        lib.ssd_error_string.argtypes = [ci]
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


def _raise_on(lib, err: int, phase: str) -> None:
    if err:
        raise RuntimeError(f"SSD scan kernel, {phase} phase, failed to "
                           f"launch: {lib.ssd_error_string(err).decode()}")


def phase_launches(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                   chunk: int
                   ) -> Tuple[List[Tuple[str, Callable[[], None]]],
                              torch.Tensor, torch.Tensor]:
    """The kernel's three launches on CUDA inputs that ``ssd`` has checked
    (``chunk`` already dividing S), not yet run: ([(phase, launch)], y, h).
    Each launch issues its CUDA kernel on the current stream, raises if the
    launch fails and else counts it in ``ssd.kernel_launches``; y and h hold the result once all three have run, in
    order. ``ssd`` runs them; chip_smoke.py also times each alone."""
    B, S, H, P = x.shape
    G, N = Bc.shape[2], Bc.shape[3]
    lib = load_library()
    plan = tile_plan(B, S, H, P, G, N, x.dtype, chunk)
    q, nc, dtype = plan["chunk"], plan["chunks"], _DTYPES[x.dtype]
    x, Bc, Cc = x.contiguous(), Bc.contiguous(), Cc.contiguous()
    dtf = dt.float().contiguous()
    Af, Df = A.float().contiguous(), D.float().contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32,
                         device=x.device)
    decays = torch.empty((B, nc, H), dtype=torch.float32, device=x.device)

    def stream():
        return torch.cuda.current_stream(x.device).cuda_stream

    def chunk_state():
        _raise_on(lib, lib.ssd_chunk_state_launch(
            x.data_ptr(), dtf.data_ptr(), Af.data_ptr(), Bc.data_ptr(),
            states.data_ptr(), decays.data_ptr(), dtype, B, S, H, P, G, N,
            q, stream()), "chunk state")
        ssd.kernel_launches["chunk_state"] += 1

    def state_pass():
        _raise_on(lib, lib.ssd_state_pass_launch(
            states.data_ptr(), decays.data_ptr(), h.data_ptr(), B, H, P, N,
            nc, stream()), "state passing")
        ssd.kernel_launches["state_pass"] += 1

    def chunk_scan():
        _raise_on(lib, lib.ssd_chunk_scan_launch(
            x.data_ptr(), dtf.data_ptr(), Af.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), Df.data_ptr(), states.data_ptr(), y.data_ptr(),
            dtype, B, S, H, P, G, N, q, plan["heads_per_block"],
            plan["groups"], stream()), "chunk scan")
        ssd.kernel_launches["chunk_scan"] += 1

    return ([("chunk_state", chunk_state), ("state_pass", state_pass),
             ("chunk_scan", chunk_scan)], y, h)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
        Cc: torch.Tensor, D: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H) (post-softplus, read as f32); A: (H,)
    (negative); Bc/Cc: (B,S,G,N); D: (H,). Returns (y (B,S,H,P) in x's
    dtype, h (B,H,P,N) f32).

    ``chunk`` is halved until it divides S, as in the JAX kernel. The
    kernels compute in chunks of at most 128 steps (``tile_plan``); the
    function does not depend on it."""
    _check(x, dt, A, Bc, Cc, D)
    S = x.shape[1]
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
    runs, y, h = phase_launches(x, dt, A, Bc, Cc, D, chunk)
    for _, run in runs:
        run()
    ssd.launches += 1
    return y, h


ssd.launches = 0
ssd.kernel_launches = {"chunk_state": 0, "state_pass": 0, "chunk_scan": 0}
reference = ssd_reference
