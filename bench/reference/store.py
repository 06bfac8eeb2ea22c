"""Plain references for the store: content addresses by ``hashlib`` and a
frozen copy of the chunk geometry.

A store keeps each chunk of a tensor's little-endian bytes under
``blobs/sha256/<first two hex digits>/<sha256 hex>``. A tensor's bytes are
cut into chunks of ``chunk_bytes`` from its first byte, the last chunk
short.
"""
from __future__ import annotations

import hashlib
import os
from typing import Iterable

import torch


def blob_path(root: str, address: str) -> str:
    return os.path.join(root, "blobs", "sha256", address[:2], address)


def misaddressed(address: str, path: str) -> bool:
    """Whether the file's SHA-256 is not its address."""
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest() != address


def chunk_of_elements(offset: int, count: int, itemsize: int,
                      chunk_bytes: int, device) -> torch.Tensor:
    """The chunk index of each of ``count`` elements that start at element
    ``offset`` of a tensor."""
    idx = torch.arange(offset, offset + count, device=device)
    return idx * itemsize // chunk_bytes


def chunk_count(numel: int, itemsize: int, chunk_bytes: int) -> int:
    return max(1, -(-numel * itemsize // chunk_bytes))


def chunk_sizes(numel: int, itemsize: int, chunk_bytes: int,
                chunks: Iterable[int]) -> int:
    """Bytes in the given chunks of a tensor of ``numel`` elements."""
    total = numel * itemsize
    return sum(min(chunk_bytes, total - j * chunk_bytes) for j in chunks)
