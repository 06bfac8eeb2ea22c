"""The chunk-fingerprint kernel, bound to PyTorch: build, launch, count.

``fingerprint_leaves`` is the wrapper. For leaves on the CPU it runs the
plain version (``ref.fingerprint_rows_plain``); for leaves on a CUDA device
it launches ``csrc/fingerprint.cu`` once for the whole tree, or raises. It
never falls back from the kernel to the plain version.
``fingerprint_leaves.launches`` counts kernel launches, and nothing else.

``fingerprint`` (one tensor) and ``fingerprint_tree`` (a whole flat
payload dict, one launch and one D2H copy) are the counterparts of the
reference's entry points of the same names, on ``core.fingerprint``'s
chunk geometry.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..build import build_all
from .ref import fingerprint_rows_plain

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "fingerprint.cu")
_lib: Optional[ctypes.CDLL] = None   # the loaded library, once per process


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_all({"fingerprint": SOURCE})["fingerprint"])
        lib.fp_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_ulonglong, ctypes.c_ulonglong,
                                  ctypes.c_void_p, ctypes.c_void_p]
        lib.fp_launch.restype = ctypes.c_int
        lib.fp_tile_bytes.argtypes = []
        lib.fp_tile_bytes.restype = ctypes.c_int
        lib.fp_error_string.argtypes = [ctypes.c_int]
        lib.fp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _leaf_table(leaves: Sequence[torch.Tensor],
                geom: Sequence[Tuple[int, int]], tile_bytes: int):
    """-> ((n_leaves, 6) uint64 table, total rows, tiles per row), checking
    each leaf against what the kernel takes."""
    table = np.zeros((len(leaves), 6), np.uint64)
    row, tiles = 0, 1
    for i, (t, (n_rows, width)) in enumerate(zip(leaves, geom)):
        if not t.is_contiguous():
            raise ValueError("fingerprint kernel needs contiguous leaves")
        lb = min(t.element_size(), 4)
        nbytes = t.numel() * t.element_size()
        ptr = t.data_ptr()
        if nbytes and ptr % lb:
            raise ValueError(f"leaf {i} is not {lb}-byte aligned")
        if nbytes and -(-nbytes // (width * lb)) != n_rows:
            raise ValueError(f"leaf {i}: {n_rows} rows of {width} lanes "
                             f"do not cover its {nbytes} bytes")
        vec = bool(nbytes) and ptr % 16 == 0 and (width * lb) % 16 == 0
        table[i] = (ptr, nbytes, row, width, lb, int(vec))
        row += n_rows
        tiles = max(tiles, -(-(width * lb) // tile_bytes))
    return table, row, tiles


def fingerprint_leaves(leaves: Sequence[torch.Tensor],
                       geom: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Leaves on one device and their (n_rows, width) geometry -> the packed
    (total_rows, 2) int32 fingerprint table on that device."""
    devices = {t.device for t in leaves}
    if len(devices) > 1:
        raise ValueError(f"leaves span several devices: {sorted(map(str, devices))}")
    device = devices.pop() if devices else torch.device("cpu")
    if device.type == "cpu":
        return fingerprint_rows_plain(leaves, geom)
    if device.type != "cuda":
        raise ValueError(f"no fingerprint kernel for device {device}")
    lib = load_library()
    table, rows, tiles = _leaf_table(leaves, geom, lib.fp_tile_bytes())
    out = torch.zeros((rows, 2), dtype=torch.int32, device=device)
    if rows == 0:
        return out
    dev_table = torch.from_numpy(table.view(np.int64)).to(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.fp_launch(dev_table.data_ptr(), len(leaves), rows, tiles,
                        out.data_ptr(), stream)
    if err:
        raise RuntimeError("fingerprint kernel launch failed: "
                           f"{lib.fp_error_string(err).decode()}")
    fingerprint_leaves.launches += 1
    return out


fingerprint_leaves.launches = 0


# ``core.fingerprint`` imports this module, so the entry points below
# import it when called
def fingerprint(t: torch.Tensor, chunk_bytes: int = 1 << 20) -> torch.Tensor:
    """-> the (n_chunks, 2) int32 fingerprints of one tensor, on its
    device (one kernel launch on the card)."""
    from ...core.fingerprint import fingerprint_chunks
    return fingerprint_chunks(t, chunk_bytes)


def fingerprint_tree(tree: Dict[str, torch.Tensor],
                     chunk_bytes: int = 1 << 20, *,
                     stats: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """name -> (n_chunks, 2) int32 fingerprints of a flat payload dict: ONE
    kernel launch and one (total_chunks, 2) D2H copy for the whole tree
    (``core.fingerprint.fingerprint_tree_packed``)."""
    from ...core.fingerprint import fingerprint_tree_packed
    return fingerprint_tree_packed(tree, chunk_bytes, stats=stats)
