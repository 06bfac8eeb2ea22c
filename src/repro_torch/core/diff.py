"""C1 — targeted change detection ("use diff to check changes") (torch
port of ``repro/core/diff.py``).

Given a stored layer and a new payload, find exactly which chunks changed.
Two detectors:

* ``diff_layer_host`` — chunk-granular SHA-256 compare on the host. The
  direct analogue of the paper's text diff. O(changed-layer bytes) of
  hashing but zero serialization of unchanged chunks to disk.

* ``diff_layer_fingerprint`` — a 64-bit on-device fingerprint per chunk
  (see core/fingerprint.py and the CUDA kernel) is compared against the
  fingerprints recorded at last save; only chunks whose fingerprint changed
  are pulled to host and SHA'd. The device->host traffic is
  O(8 B x chunks + changed bytes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .chunker import (TensorRecord, dtype_str, hash_chunks, iter_chunks,
                      shape_of, tensor_chunk_bytes, tensor_to_bytes)
from .fingerprint import fingerprint_chunk_bytes_ref
from .manifest import LayerDescriptor


@dataclass
class ChunkEdit:
    tensor: str
    index: int          # chunk index within the tensor
    new_hash: str
    data: bytes
    # Fingerprint of the NEW chunk bytes ((xor, sum) int32 pair) when the
    # edited record carries a fingerprint sidecar — lets apply_edits keep
    # ``TensorRecord.fp`` alive across injection so the next build_image
    # COPY prefilter never falls back to a full re-hash.
    fp: Optional[Tuple[int, int]] = None


@dataclass
class LayerDiff:
    layer_id: str
    edits: List[ChunkEdit] = field(default_factory=list)
    structure_changed: bool = False   # shape/dtype/tree change => "compiled"
    added: List[str] = field(default_factory=list)
    removed: List[str] = field(default_factory=list)
    chunks_prefiltered: int = 0       # chunks skipped by the fingerprint
                                      # prefilter (no serialize, no SHA)

    @property
    def is_empty(self) -> bool:
        return (not self.edits and not self.structure_changed
                and not self.added and not self.removed)

    @property
    def injectable(self) -> bool:
        """The paper's interpreted-language condition: the stored bytes ARE
        the artifact (value-only change). Structure changes are 'compiled' —
        the derived artifacts must be rebuilt."""
        return not self.structure_changed


def _host_compare_tensor(rec, name: str, arr, diff: LayerDiff) -> None:
    """Serialize + SHA every chunk of one tensor and record the edits
    (the non-prefiltered compare, shared by both diff paths)."""
    data = tensor_to_bytes(arr)
    pieces = list(iter_chunks(data, rec.chunk_bytes))
    for i, h in enumerate(hash_chunks(pieces)):
        if h != rec.chunks[i]:
            fp = fingerprint_chunk_bytes_ref(
                pieces[i], rec.dtype, rec.chunk_bytes) \
                if rec.fp is not None else None
            diff.edits.append(ChunkEdit(name, i, h, bytes(pieces[i]), fp=fp))


def diff_layer_host(layer: LayerDescriptor,
                    payload: Dict[str, torch.Tensor]) -> LayerDiff:
    diff = LayerDiff(layer_id=layer.layer_id)
    by_name = {r.name: r for r in layer.records}
    diff.added = sorted(set(payload) - set(by_name))
    diff.removed = sorted(set(by_name) - set(payload))
    if diff.added or diff.removed:
        diff.structure_changed = True
    for name, rec in by_name.items():
        if name not in payload:
            continue
        arr = payload[name]
        if shape_of(arr) != rec.shape or dtype_str(arr) != rec.dtype:
            diff.structure_changed = True
            continue
        _host_compare_tensor(rec, name, arr, diff)
    return diff


def diff_layer_fingerprint(layer: LayerDescriptor,
                           payload: Dict[str, torch.Tensor],
                           old_fps: Dict[str, np.ndarray],
                           new_fps: Dict[str, np.ndarray]) -> LayerDiff:
    """Fingerprint-prefiltered diff. ``old_fps``/``new_fps`` map tensor name
    -> (n_chunks, 2) int32 fingerprints (from core.fingerprint). Only chunks
    whose fingerprint changed are serialized + SHA'd — and only the changed
    chunk RANGES of a tensor are serialized (``tensor_chunk_bytes``), never
    the whole array. Tensors with no recorded old fingerprint fall back to
    the host SHA compare. ``diff.chunks_prefiltered`` counts the chunks the
    prefilter proved unchanged (zero serialize/hash cost).
    """
    diff = LayerDiff(layer_id=layer.layer_id)
    by_name = {r.name: r for r in layer.records}
    diff.added = sorted(set(payload) - set(by_name))
    diff.removed = sorted(set(by_name) - set(payload))
    if diff.added or diff.removed:
        diff.structure_changed = True
    for name, rec in by_name.items():
        if name not in payload:
            continue
        arr = payload[name]
        if shape_of(arr) != rec.shape or dtype_str(arr) != rec.dtype:
            diff.structure_changed = True
            continue
        if name not in old_fps or name not in new_fps:
            # no fingerprint history: full host compare for this tensor
            _host_compare_tensor(rec, name, arr, diff)
            continue
        fp_old, fp_new = np.asarray(old_fps[name]), np.asarray(new_fps[name])
        if fp_old.shape[0] != len(rec.chunks) or \
                fp_new.shape[0] != len(rec.chunks):
            # fingerprint/record geometry mismatch (e.g. the store was
            # reopened with a different chunk_bytes): the prefilter is
            # meaningless — compare every chunk rather than silently
            # dropping out-of-range indices
            _host_compare_tensor(rec, name, arr, diff)
            continue
        changed = np.nonzero(np.any(fp_old != fp_new, axis=-1))[0]
        diff.chunks_prefiltered += len(rec.chunks) - int(changed.size)
        if changed.size == 0:
            continue
        idxs = [int(i) for i in changed.tolist()]
        pieces = [tensor_chunk_bytes(arr, i, rec.chunk_bytes) for i in idxs]
        for i, piece, h in zip(idxs, pieces, hash_chunks(pieces)):
            if h != rec.chunks[i]:
                # new fingerprint comes free from the already-computed table
                fp = (int(fp_new[i, 0]), int(fp_new[i, 1]))
                diff.edits.append(ChunkEdit(name, i, h, piece, fp=fp))
    return diff


def locate_changed_layers(layers: Sequence[LayerDescriptor],
                          payloads: Dict[str, Dict[str, torch.Tensor]],
                          ) -> List[Tuple[LayerDescriptor, LayerDiff]]:
    """Walk the image's layers 'Dockerfile line by line' (paper §III.A) and
    return (layer, diff) pairs for every changed content layer — a tuple
    view over ``diff_image`` (the {layer_id: diff} form injection takes)."""
    by_id = {layer.layer_id: layer for layer in layers}
    return [(by_id[lid], d)
            for lid, d in diff_image(layers, payloads).items()]


def diff_manifests(base_layers: Sequence[LayerDescriptor],
                   new_layers: Sequence[LayerDescriptor],
                   ) -> Tuple[List[LayerDescriptor], Dict[str, str],
                              set]:
    """Metadata-level image delta for replication (core.delta /
    core.registry): (missing layers, re-key table, new chunk ids) of
    ``new_layers`` relative to ``base_layers``.

    A new layer whose family has a content-checksum-equal revision in the
    base is a re-keyed clone (same records, new chain) — its chunks are by
    definition already present wherever the base is. Everything else is
    new content; its chunk set minus the base's chunk set is what a
    DeltaBundle must carry.
    """
    base_ids = {layer.layer_id for layer in base_layers}
    by_family: Dict[Tuple[str, str], str] = {}
    base_chunks: set = set()
    for layer in base_layers:
        by_family.setdefault((layer.family, layer.checksum), layer.layer_id)
        for rec in layer.records:
            base_chunks.update(rec.chunks)

    missing: List[LayerDescriptor] = []
    rekey: Dict[str, str] = {}
    chunks: set = set()
    for layer in new_layers:
        if layer.layer_id in base_ids:
            continue
        missing.append(layer)
        twin = by_family.get((layer.family, layer.checksum))
        if twin is not None:
            rekey[layer.layer_id] = twin
            continue
        for rec in layer.records:
            chunks.update(h for h in rec.chunks if h not in base_chunks)
    return missing, rekey, chunks


def diff_tensor_records(old_layers: Sequence[LayerDescriptor],
                        new_layers: Sequence[LayerDescriptor],
                        ) -> Optional[set]:
    """Tensor-level sparse-update plan between two stored revisions of one
    image: the set of tensor names whose stored records differ (any chunk
    hash moved). Pure metadata — no blob is read — which is what lets a
    serving replica refresh O(changed tensors) instead of O(model) after a
    delta pull. Returns ``None`` when the change is structural (tensor
    added/removed, shape or dtype change): value-only injection can't have
    produced it, so callers must fall back to a full reload. Assumes tensor
    names are unique across the image's content layers (true for every
    checkpoint image; images violating it also get the full-reload answer
    via the ambiguity check below)."""
    def index(layers):
        recs: Dict[str, TensorRecord] = {}
        for layer in layers:
            if layer.empty:
                continue
            for r in layer.records:
                if r.name in recs:          # ambiguous name: no sparse plan
                    return None
                recs[r.name] = r
        return recs

    old, new = index(old_layers), index(new_layers)
    if old is None or new is None or set(old) != set(new):
        return None
    changed = set()
    for name, rec in new.items():
        prev = old[name]
        if prev.shape != rec.shape or prev.dtype != rec.dtype or \
                prev.chunk_bytes != rec.chunk_bytes:
            return None
        if prev.chunks != rec.chunks:
            changed.add(name)
    return changed


def diff_image(layers: Sequence[LayerDescriptor],
               payloads: Dict[str, Dict[str, torch.Tensor]],
               old_fps: Optional[Dict[str, np.ndarray]] = None,
               new_fps: Optional[Dict[str, np.ndarray]] = None,
               ) -> Dict[str, LayerDiff]:
    """C1 over a whole image: one non-empty LayerDiff per targeted content
    layer, keyed by layer_id — the input unit of ``inject_image_multi``.
    Passing both fingerprint tables switches every layer to the prefiltered
    detector; otherwise the host SHA compare runs."""
    diffs: Dict[str, LayerDiff] = {}
    for layer in layers:
        if layer.empty:
            continue
        key = layer.instruction.arg
        if key not in payloads:
            continue
        if old_fps is not None and new_fps is not None:
            d = diff_layer_fingerprint(layer, payloads[key],
                                       old_fps, new_fps)
        else:
            d = diff_layer_host(layer, payloads[key])
        if not d.is_empty:
            diffs[layer.layer_id] = d
    return diffs
