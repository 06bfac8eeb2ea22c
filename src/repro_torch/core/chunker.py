"""Tensor <-> content-addressed chunk serialization (torch port of
``repro/core/chunker.py``).

A leaf is serialized to raw little-endian bytes and split into fixed-size
chunks, the smallest addressable unit of the store. The byte stream, the
chunk boundaries, the SHA-256 addresses and the ``TensorRecord`` JSON are
identical to the JAX package's, so either package reads the other's store.

The torch boundary lives here:

* ``dtype_str`` names a dtype the numpy way (``"bfloat16"``, ``"bool"``),
  never ``"torch.bfloat16"``: ``diff.py`` compares these strings against the
  stored records, and drift would turn every save into a full rebuild.
* ``tensor_to_bytes`` / ``tensor_chunk_bytes`` copy a device tensor to the
  host through a ``uint8`` view (numpy has no bf16), and
  ``tensor_chunk_bytes`` copies only the requested chunk's byte range.
* ``bytes_to_tensor`` rebuilds a torch tensor on a given device.
"""
from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.fingerprint.ref import byte_view

DEFAULT_CHUNK_BYTES = 1 << 20  # 1 MiB

# Shared hashing pool. hashlib releases the GIL on large buffers, so SHA-256
# over many chunks parallelizes well; small batches stay on the caller
# thread to avoid pool dispatch overhead.
_HASH_POOL_WORKERS = min(8, os.cpu_count() or 1)
_HASH_POOL = ThreadPoolExecutor(max_workers=_HASH_POOL_WORKERS,
                                thread_name_prefix="repro-torch-sha")
_PARALLEL_MIN_BYTES = 1 << 18   # don't fan out tiny batches

_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "uint16": torch.uint16, "int32": torch.int32, "uint32": torch.uint32,
    "int64": torch.int64, "uint64": torch.uint64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}

_DTYPE_SIZES = {
    "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
    "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
    "int32": 4, "uint32": 4, "int64": 8, "uint64": 8, "bool": 1,
}


def sha256_hex(data) -> str:
    return hashlib.sha256(data).hexdigest()


def hash_pool() -> Optional[ThreadPoolExecutor]:
    """The shared SHA/transfer executor (None on single-core boxes).

    Shared by chunk hashing and the registry's pipelined blob transfer —
    tasks submitted here must hash inline (``sha256_hex``), never via
    ``hash_chunks``, so the pool cannot deadlock on itself."""
    return _HASH_POOL if _HASH_POOL_WORKERS > 1 else None


def hash_chunks(pieces: Sequence) -> List[str]:
    """SHA-256 a batch of bytes-like chunks, fanning out to the shared pool
    when the batch is large enough for the GIL release to pay off."""
    pieces = list(pieces)
    if len(pieces) > 1 and _HASH_POOL_WORKERS > 1 and \
            sum(len(p) for p in pieces) >= _PARALLEL_MIN_BYTES:
        return list(_HASH_POOL.map(sha256_hex, pieces))
    return [sha256_hex(p) for p in pieces]


@dataclass(frozen=True)
class TensorRecord:
    """Descriptor of one serialized tensor inside a layer."""

    name: str                 # tree path, e.g. "params/blocks/wq"
    shape: Tuple[int, ...]
    dtype: str                # numpy dtype string, e.g. "bfloat16"
    chunk_bytes: int
    chunks: Tuple[str, ...]   # sha256 hex of each chunk, in order
    # Optional per-chunk fingerprint sidecar ((xor, sum) int32 pairs, see
    # core/fingerprint.py). NOT part of the layer content checksum: it lets
    # build_image's COPY cache check prefilter instead of re-hashing.
    fp: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def nbytes(self) -> int:
        n = int(np.prod(self.shape)) if self.shape else 1
        return n * dtype_itemsize(self.dtype)

    def to_json(self) -> dict:
        d = {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "chunk_bytes": self.chunk_bytes,
            "chunks": list(self.chunks),
        }
        if self.fp is not None:
            d["fp"] = [list(p) for p in self.fp]
        return d

    @staticmethod
    def from_json(d: dict) -> "TensorRecord":
        fp = d.get("fp")
        return TensorRecord(
            name=d["name"],
            shape=tuple(d["shape"]),
            dtype=d["dtype"],
            chunk_bytes=int(d["chunk_bytes"]),
            chunks=tuple(d["chunks"]),
            fp=tuple(tuple(int(x) for x in p) for p in fp)
            if fp is not None else None,
        )


def dtype_itemsize(dtype: str) -> int:
    if dtype in _DTYPE_SIZES:
        return _DTYPE_SIZES[dtype]
    return np.dtype(dtype).itemsize


def dtype_str(t: torch.Tensor) -> str:
    """The numpy-style dtype name the store records ("bfloat16", "bool")."""
    try:
        return _DTYPE_NAMES[t.dtype]
    except KeyError:
        raise TypeError(f"dtype {t.dtype} has no store encoding") from None


def torch_dtype(dtype: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[dtype]
    except KeyError:
        raise TypeError(f"dtype {dtype!r} has no torch counterpart") from None


def shape_of(t: torch.Tensor) -> Tuple[int, ...]:
    return tuple(int(s) for s in t.shape)


def tensor_to_bytes(t: torch.Tensor) -> memoryview:
    """Serialize a tensor (any device) to contiguous little-endian bytes:
    one D2H copy of the whole tensor, returned as a read-only bytes-like
    view of the host copy (no second copy into a ``bytes`` object)."""
    return memoryview(byte_view(t).cpu().numpy()).toreadonly()


def bytes_to_tensor(data, shape: Tuple[int, ...], dtype: str,
                    device="cpu") -> torch.Tensor:
    """Rebuild a tensor from its serialized bytes, on ``device``."""
    b = torch.empty(len(data), dtype=torch.uint8)
    b.numpy()[:] = np.frombuffer(data, dtype=np.uint8)
    return b.view(torch_dtype(dtype)).reshape(shape).to(device)


def iter_chunks(data, chunk_bytes: int = DEFAULT_CHUNK_BYTES
                ) -> Iterator[memoryview]:
    """Split a bytes-like object into chunk-sized ZERO-COPY memoryviews."""
    mv = memoryview(data)
    for off in range(0, max(len(mv), 1), chunk_bytes):
        yield mv[off:off + chunk_bytes]


def tensor_chunk_bytes(t: torch.Tensor, chunk_idx: int,
                       chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> bytes:
    """Serialize ONLY chunk ``chunk_idx`` of a tensor: byte-identical to
    ``tensor_to_bytes(t)[chunk_idx*cb:(chunk_idx+1)*cb]``, but only that
    range crosses D2H."""
    itemsize = t.element_size()
    if chunk_bytes % itemsize:
        # pathological chunk size: fall back to the full serialization
        data = tensor_to_bytes(t)
        return bytes(data[chunk_idx * chunk_bytes:(chunk_idx + 1) * chunk_bytes])
    flat = t.detach().reshape(-1)
    epc = chunk_bytes // itemsize
    seg = flat[chunk_idx * epc:(chunk_idx + 1) * epc]
    return byte_view(seg).cpu().numpy().tobytes()


def chunk_tensor(name: str, t: torch.Tensor,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
    """-> (TensorRecord, [(sha256, memoryview), ...]) for every chunk."""
    data = tensor_to_bytes(t)
    pieces = list(iter_chunks(data, chunk_bytes))
    hashes = hash_chunks(pieces)
    pairs: List[Tuple[str, memoryview]] = list(zip(hashes, pieces))
    rec = TensorRecord(
        name=name,
        shape=shape_of(t),
        dtype=dtype_str(t),
        chunk_bytes=chunk_bytes,
        chunks=tuple(hashes),
    )
    return rec, pairs


def assemble_tensor(rec: TensorRecord, read_blob) -> torch.Tensor:
    """Rebuild a host tensor from its chunk records (each blob is copied
    once, straight into the tensor's buffer)."""
    b = torch.empty(rec.nbytes, dtype=torch.uint8)
    dst = b.numpy()
    off = 0
    for h in rec.chunks:
        piece = np.frombuffer(read_blob(h), dtype=np.uint8)
        dst[off:off + piece.size] = piece
        off += piece.size
    if off != rec.nbytes:
        raise ValueError(f"{rec.name}: chunks hold {off} bytes, "
                         f"record says {rec.nbytes}")
    return b.view(torch_dtype(rec.dtype)).reshape(rec.shape)
