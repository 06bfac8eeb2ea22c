"""On-device chunk fingerprints — the change detector (C1) (torch port of
``repro/core/fingerprint.py``).

A save computes a 64-bit mixing fingerprint per chunk of every leaf, on the
device that holds the leaf, and ships only the (total_chunks, 2) int32
table to the host. Chunks whose fingerprint changed since the last save
are then fetched and SHA-256'd for the store; the fingerprint is only a
prefilter. Both reductions (xor, wrapping add) are associative and
commutative, so the table is bit-identical to the JAX package's whatever
the order of the sums.

``fingerprint_tree_packed`` fingerprints a whole flat payload dict with ONE
kernel launch (kernels/fingerprint/csrc/fingerprint.cu) when the leaves
are on a CUDA device, and with the plain torch version when they are on
the CPU. The kernel reads every leaf in place: there is no padded
(total_chunks, max_lanes) buffer as on the TPU path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.fingerprint.ops import fingerprint_leaves
from .chunker import bytes_to_tensor, dtype_itemsize, dtype_str, shape_of


def chunk_geometry(shape: Tuple[int, ...], dtype: str,
                   chunk_bytes: int) -> Tuple[int, int]:
    """-> (n_chunks, lanes_per_chunk) for a tensor, matching both
    chunker.iter_chunks boundaries on the serialized bytes and the u32 lane
    layout (sub-32-bit dtypes widen to one lane per element; 64-bit dtypes
    split into two lanes per element)."""
    itemsize = dtype_itemsize(dtype)
    lanes_per_elem = 2 if itemsize == 8 else 1
    elems_per_chunk = max(1, chunk_bytes // itemsize)
    n = 1
    for s in shape:
        n *= int(s)
    if not shape:
        n = 1
    n_chunks = max(1, -(-n // elems_per_chunk))
    lanes_per_chunk = elems_per_chunk * lanes_per_elem if n else 1
    return n_chunks, lanes_per_chunk


def tree_pack_index(tree: Dict[str, torch.Tensor], chunk_bytes: int
                    ) -> Tuple[List[Tuple[str, int, int]], int, int]:
    """-> ([(name, row_offset, n_chunks), ...], total_chunks, max_lanes).
    Row ``row_offset + j`` of the packed table holds chunk ``j`` of
    ``name``."""
    index: List[Tuple[str, int, int]] = []
    row = 0
    max_lanes = 1
    for name, v in tree.items():
        n_chunks, lanes = chunk_geometry(shape_of(v), dtype_str(v),
                                         chunk_bytes)
        index.append((name, row, n_chunks))
        row += n_chunks
        max_lanes = max(max_lanes, lanes)
    return index, row, max_lanes


def fingerprint_tree_packed(tree: Dict[str, torch.Tensor],
                            chunk_bytes: int = 1 << 20, *,
                            stats: Optional[dict] = None
                            ) -> Dict[str, np.ndarray]:
    """name -> (n_chunks, 2) int32 fingerprints for a flat payload dict.

    If any leaf is on a CUDA device, every leaf is taken to that device
    (the odd small host leaf, such as the step counter, is copied over) and
    the whole tree costs one kernel launch and one D2H copy of the
    (total_chunks, 2) table. A tree on the CPU runs the plain version.
    ``stats`` accumulates "bytes_d2h" (table bytes shipped to the host) and
    "device_dispatches"."""
    if not tree:
        return {}
    names = list(tree)
    index, _, _ = tree_pack_index(tree, chunk_bytes)
    device = next((t.device for t in tree.values() if t.device.type == "cuda"),
                  torch.device("cpu"))
    leaves = [tree[n].detach().to(device).contiguous() for n in names]
    geom = [chunk_geometry(shape_of(t), dtype_str(t), chunk_bytes)
            for t in leaves]
    fp_all = fingerprint_leaves(leaves, geom).cpu().numpy()
    if stats is not None:
        stats["bytes_d2h"] = stats.get("bytes_d2h", 0) + fp_all.nbytes
        stats["device_dispatches"] = stats.get("device_dispatches", 0) + 1
    return {name: fp_all[off:off + n] for name, off, n in index}


def fingerprint_chunk_bytes_ref(data, dtype: str,
                                chunk_bytes: int = 1 << 20
                                ) -> Optional[Tuple[int, int]]:
    """Fingerprint ONE serialized chunk on the host: bit-identical to the
    row this chunk gets in the whole-tensor table (lane positions restart
    at 0 per chunk; a partial final chunk zero-pads to the full width).
    Returns None for chunk sizes that do not align to the dtype's itemsize:
    no per-chunk recompute can match the whole-tensor table there, and
    callers drop the sidecar instead."""
    if chunk_bytes % dtype_itemsize(dtype) or \
            len(data) % dtype_itemsize(dtype):
        return None
    t = bytes_to_tensor(bytes(data), (-1,), dtype)
    fp = fingerprint_tree_packed({"chunk": t}, chunk_bytes)["chunk"]
    return int(fp[0, 0]), int(fp[0, 1])
