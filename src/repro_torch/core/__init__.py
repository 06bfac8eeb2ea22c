"""The layered, content-addressed store for model state with O(delta)
injection updates and a verifying delta registry (torch port of
``repro.core``)."""
from .chunker import (DEFAULT_CHUNK_BYTES, TensorRecord, bytes_to_tensor,
                      chunk_tensor, dtype_str, hash_chunks, hash_pool,
                      iter_chunks, sha256_hex, tensor_chunk_bytes,
                      tensor_to_bytes)
from .delta import (BundleEntry, BundleIndex, DeltaBundle, DeltaFormatError,
                    compose_delta_records, decode_delta, decode_index,
                    encode_delta, encode_index, plan_bundle_chain)
from .diff import (ChunkEdit, LayerDiff, diff_image, diff_layer_fingerprint,
                   diff_layer_host, diff_manifests, diff_tensor_records,
                   locate_changed_layers)
from .fingerprint import (chunk_geometry, fingerprint_chunk_bytes_ref,
                          fingerprint_chunks, fingerprint_chunks_ref,
                          fingerprint_tree, fingerprint_tree_packed,
                          fingerprint_tree_ref, tree_pack_index)
from .inject import (StructureChangeError, apply_edits, clone_layer,
                     inject_image, inject_image_multi, inject_payload_update)
from .manifest import (ImageConfig, Instruction, LayerDescriptor, Manifest,
                       chain_checksum, content_checksum, history_delta_chain,
                       injection_history_entry, new_uuid)
from .registry import (DeltaReceiver, FanoutStats, HaveSet, PassiveRegistry,
                       PushRejected, PushStats, RelayNode, RepairFailed,
                       RepairReport, RepairSession, ReplicaResult,
                       export_delta, import_delta, pull, pull_delta, push,
                       push_delta, repair_image, replicate_fanout,
                       squash_deltas, verify_squashed_bundle)
from .store import BuildReport, HoldingsIndex, LayerStore

__all__ = [
    "DEFAULT_CHUNK_BYTES", "TensorRecord", "bytes_to_tensor", "chunk_tensor",
    "dtype_str", "hash_chunks", "hash_pool", "iter_chunks", "sha256_hex",
    "tensor_chunk_bytes", "tensor_to_bytes",
    "BundleEntry", "BundleIndex", "DeltaBundle", "DeltaFormatError",
    "compose_delta_records", "decode_delta", "decode_index", "encode_delta",
    "encode_index", "plan_bundle_chain",
    "ChunkEdit", "LayerDiff", "diff_image", "diff_layer_fingerprint",
    "diff_layer_host", "diff_manifests", "diff_tensor_records",
    "locate_changed_layers",
    "chunk_geometry", "fingerprint_chunk_bytes_ref", "fingerprint_chunks",
    "fingerprint_chunks_ref", "fingerprint_tree", "fingerprint_tree_packed",
    "fingerprint_tree_ref", "tree_pack_index",
    "StructureChangeError", "apply_edits", "clone_layer", "inject_image",
    "inject_image_multi", "inject_payload_update",
    "ImageConfig", "Instruction", "LayerDescriptor", "Manifest",
    "chain_checksum", "content_checksum", "history_delta_chain",
    "injection_history_entry", "new_uuid",
    "DeltaReceiver", "FanoutStats", "HaveSet", "PassiveRegistry",
    "PushRejected", "PushStats", "RelayNode", "RepairFailed", "RepairReport",
    "RepairSession", "ReplicaResult", "export_delta", "import_delta", "pull",
    "pull_delta", "push", "push_delta", "repair_image", "replicate_fanout",
    "squash_deltas", "verify_squashed_bundle",
    "BuildReport", "HoldingsIndex", "LayerStore",
]
