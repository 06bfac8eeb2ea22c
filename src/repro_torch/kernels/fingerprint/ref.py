"""Plain PyTorch version of the chunk fingerprint: the same function as the
CUDA kernel in ``csrc/fingerprint.cu``, in int64 arithmetic masked to 32
bits (torch has no wrapping uint32 multiply, and its int32 ``>>`` is an
arithmetic shift). The CPU path and the tests use it; on the card it is
the kernel's yardstick of correctness, never its fallback.

A row is ``width`` u32 lanes. Lane ``p`` of row ``r`` holds the little-endian
value of the leaf's bytes ``[(r*width + p)*lb, ... + lb)`` with
``lb = min(itemsize, 4)`` (8- and 16-bit values widen, bool reads as its
0/1 byte, 64-bit values split into their low then high word, as numpy's
``view(np.uint32)`` orders them); lanes past the leaf's bytes are zero and
are still mixed. Each lane mixes as ``m = (u*C1) ^ (pos*C2 + C3);
m ^= m >> 15; m *= C3`` and a row reduces to (xor, sum mod 2**32), stored
as the int32 bit patterns.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["byte_view", "fingerprint_rows_plain", "fingerprint_chunks_ref"]

C1, C2, C3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_M32 = 0xFFFFFFFF
# lanes per processing step: bounds the int64 temporaries to ~128 MiB each
_STEP_LANES = 1 << 24


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for 0 <= a < 2**32, without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(u: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    m = _mul32(u, C1) ^ ((_mul32(pos, C2) + C3) & _M32)
    m = m ^ (m >> 15)           # logical: m is a non-negative int64
    return _mul32(m, C3)


def _xor_reduce_rows(x: torch.Tensor) -> torch.Tensor:
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        h = x.shape[1] // 2
        x = x[:, :h] ^ x[:, h:]
    return x[:, 0]


def _as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    return (v - ((v >> 31) << 32)).to(torch.int32)


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """Flat ``uint8`` view of a tensor's little-endian bytes, on its own
    device (bf16 and bool have no numpy dtype; their bytes do)."""
    if t.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _leaf_rows(t: torch.Tensor, n_rows: int, width: int) -> torch.Tensor:
    """(n_rows, 2) int32 fingerprints of one leaf, a block of rows at a
    time so the int64 temporaries stay bounded on a multi-GB leaf."""
    data = byte_view(t)
    lb = min(t.element_size(), 4)
    rows_per_step = max(1, _STEP_LANES // width)
    pos = torch.arange(width, dtype=torch.int64, device=t.device)
    out = []
    for r0 in range(0, n_rows, rows_per_step):
        r1 = min(n_rows, r0 + rows_per_step)
        seg = data[r0 * width * lb:r1 * width * lb].reshape(-1, lb) \
            .to(torch.int64)
        u = torch.zeros((r1 - r0) * width, dtype=torch.int64, device=t.device)
        u[:seg.shape[0]] = seg[:, 0]
        for k in range(1, lb):
            u[:seg.shape[0]] |= seg[:, k] << (8 * k)
        m = _mix(u.view(r1 - r0, width), pos)
        out.append(torch.stack([_xor_reduce_rows(m), m.sum(dim=1) & _M32],
                               dim=1))
    return _as_int32_bits(torch.cat(out))


def fingerprint_rows_plain(leaves: Sequence[torch.Tensor],
                           geom: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Leaves (on one device) and their (n_rows, width) -> the packed
    (total_rows, 2) int32 fingerprint table, rows in leaf order."""
    if not leaves:
        return torch.zeros((0, 2), dtype=torch.int32)
    return torch.cat([_leaf_rows(t, n, w) for t, (n, w) in zip(leaves, geom)])


def __getattr__(name: str):
    """``fingerprint_chunks_ref``, the host oracle the reference's module
    re-exports, bound on first use: ``core/fingerprint.py`` imports this
    module (through ``core/chunker.py`` and ``ops.py``), so it cannot be
    imported here at the top."""
    if name == "fingerprint_chunks_ref":
        from ...core.fingerprint import fingerprint_chunks_ref
        return fingerprint_chunks_ref
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
