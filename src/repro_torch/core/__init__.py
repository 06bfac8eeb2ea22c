"""The layered, content-addressed store for model state with O(delta)
injection updates (torch port of ``repro.core``: the parts that saving and
serving use)."""
from .chunker import (DEFAULT_CHUNK_BYTES, TensorRecord, bytes_to_tensor,
                      chunk_tensor, dtype_str, hash_chunks, iter_chunks,
                      sha256_hex, tensor_chunk_bytes, tensor_to_bytes)
from .diff import (ChunkEdit, LayerDiff, diff_image, diff_layer_fingerprint,
                   diff_layer_host, diff_tensor_records)
from .fingerprint import (chunk_geometry, fingerprint_chunk_bytes_ref,
                          fingerprint_tree_packed, tree_pack_index)
from .inject import (StructureChangeError, apply_edits, clone_layer,
                     inject_image_multi)
from .manifest import (ImageConfig, Instruction, LayerDescriptor, Manifest,
                       chain_checksum, content_checksum,
                       injection_history_entry, new_uuid)
from .store import BuildReport, LayerStore

__all__ = [
    "DEFAULT_CHUNK_BYTES", "TensorRecord", "bytes_to_tensor", "chunk_tensor",
    "dtype_str", "hash_chunks", "iter_chunks", "sha256_hex",
    "tensor_chunk_bytes", "tensor_to_bytes",
    "ChunkEdit", "LayerDiff", "diff_image", "diff_layer_fingerprint",
    "diff_layer_host", "diff_tensor_records",
    "chunk_geometry", "fingerprint_chunk_bytes_ref",
    "fingerprint_tree_packed", "tree_pack_index",
    "StructureChangeError", "apply_edits", "clone_layer",
    "inject_image_multi",
    "ImageConfig", "Instruction", "LayerDescriptor", "Manifest",
    "chain_checksum", "content_checksum", "injection_history_entry",
    "new_uuid",
    "BuildReport", "LayerStore",
]
