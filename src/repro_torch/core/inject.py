"""C2 + C3 + C4 — the code injection method itself (torch port of
``repro/core/inject.py``; the store contents it writes are identical).

``inject_image_multi`` performs the paper's full pipeline on a stored image
for ANY number of targeted content layers in one transaction:

  1. (C1) caller supplies per-layer ``LayerDiff``s (from core.diff) keyed by
     layer_id — ``diff_image`` builds that map for a whole payload set.
  2. Validation happens for the WHOLE batch before a single byte is
     written: an unknown target, a config-layer target or a structure
     ("compiled") change aborts with the store untouched.
  3. (C4) clone-before-inject, all targeted layers UP FRONT: each changed
     layer gets a NEW layer id whose records initially share every chunk
     blob with the original (an O(#chunks) metadata copy — blobs are
     content-addressed and immutable, so "two identical layers" costs no
     payload bytes). The old image and any other image dedup-sharing the
     old layers are untouched.
  4. (C2) injection: write only the changed chunk blobs into the clones.
     Edits carrying fingerprints (``ChunkEdit.fp``) refresh the
     ``TensorRecord.fp`` sidecar in place, so the next ``build_image`` COPY
     prefilter stays a fingerprint compare instead of a full re-hash.
  5. (C3) checksum bypass, "update both the key and the lock", as ONE
     downstream walk regardless of how many layers were injected: each
     clone's content checksum was recomputed from its (mostly reused) chunk
     hashes; the chain checksums of every downstream layer are re-keyed
     exactly once. Downstream layers keep their content (and content
     checksum) — they are *re-keyed*, not re-built. Scenario-4 rule: a
     downstream RUN layer whose ``derives_from`` names ANY injected payload
     is a *derived* artifact and is re-derived — but at most ONCE, even
     when several upstream injections hit it (the paper: "we must not only
     inject code in the layer containing the source code but also rebuild
     the layer after it that compiles the source code"). Config layers are
     left to the normal (cheap, empty-layer) path.
  6. ONE manifest/config commit. Under ``durability="batch"`` (the
     default) every blob/layer fsync of the batch is deferred to this
     commit point and flushed concurrently; the manifest rename stays the
     commit point, so a crash anywhere mid-batch leaves the previous image
     fully intact (orphaned blobs are GC fodder, never corruption).

The transactional unit is therefore the IMAGE, not the layer: a save that
touches embed+blocks+head costs one walk and one commit, not three — the
per-layer O(k·#layers) metadata cost collapses back to the paper's O(1).
``BuildReport.per_layer`` attributes chunks/bytes/re-keys/re-derivations to
each source layer; ``rekey_walks`` and ``manifest_commits`` prove the
single-walk/single-commit claim.

``inject_image`` (the single-image API) is a thin wrapper running the same
pipeline under the store's own durability mode, and
``inject_payload_update`` diffs new payload values on the host first.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..tracing import span
from .chunker import TensorRecord
from .diff import LayerDiff, diff_image
from .fingerprint import fingerprint_chunk_bytes_ref
from .manifest import (ImageConfig, LayerDescriptor, Manifest, chain_checksum,
                       content_checksum, injection_history_entry, new_uuid)
from .store import BuildReport, LayerStore


# Injection commits keep at most this many trailing history entries in the
# ImageConfig (the full per-save audit lives in the returned BuildReport).
_HISTORY_CAP = 64
# ... and each entry's delta record lists at most this many chunk ids
# (n_chunks records the true count; see the commit-phase comment).
_DELTA_CHUNKS_CAP = 256


class StructureChangeError(ValueError):
    """Raised when asked to inject a 'compiled' (structure) change — the
    paper's integrity rule: literal injection cannot guarantee integrity for
    compiled artifacts; callers must fall back to a rebuild."""


@contextlib.contextmanager
def _durability_scope(store: LayerStore, mode: Optional[str]):
    """Temporarily override the store's durability for one transaction.
    ``None`` keeps the store's own mode. The commit point (write_image ->
    sync_for_commit) always flushes deferred writes, so restoring the
    previous mode afterwards never drops durability."""
    if mode is None or mode == store.durability:
        yield
        return
    if mode not in ("full", "batch"):
        raise ValueError(f"unknown durability mode {mode!r}")
    prev = store.durability
    store.durability = mode
    try:
        yield
    finally:
        store.durability = prev


def clone_layer(layer: LayerDescriptor) -> LayerDescriptor:
    """C4: identical layer under a fresh id (metadata-only; blobs shared)."""
    return LayerDescriptor(
        layer_id=new_uuid(),
        version=layer.version + 1,
        instruction=layer.instruction,
        checksum=layer.checksum,
        chain=layer.chain,
        records=list(layer.records),
        empty=layer.empty,
        family=layer.family,
    )


def apply_edits(store: LayerStore, layer: LayerDescriptor, diff: LayerDiff,
                report: BuildReport) -> LayerDescriptor:
    """C2+C3 on a single (already cloned) layer.

    Edits carrying a new-chunk fingerprint (``ChunkEdit.fp``) refresh the
    record's fingerprint sidecar in place; an edit without one on a
    fingerprinted record computes it host-side from the chunk bytes (only
    changed chunks pay), so injection never drops the sidecar."""
    if not diff.injectable:
        raise StructureChangeError(
            f"layer {diff.layer_id}: structure change is not injectable")
    by_name = {r.name: i for i, r in enumerate(layer.records)}
    records = list(layer.records)
    for edit in diff.edits:
        idx = by_name[edit.tensor]
        rec = records[idx]
        chunks = list(rec.chunks)
        chunks[edit.index] = edit.new_hash
        fp = rec.fp
        if fp is not None:
            new_fp = edit.fp
            if new_fp is None:
                new_fp = fingerprint_chunk_bytes_ref(
                    edit.data, rec.dtype, rec.chunk_bytes)
            if new_fp is None:
                # misaligned chunk size: no per-chunk recompute can match
                # the whole-tensor table — drop this record's sidecar
                fp = None
            else:
                fp = list(fp)
                fp[edit.index] = (int(new_fp[0]), int(new_fp[1]))
                fp = tuple(fp)
        if store.write_blob(edit.new_hash, edit.data):
            report.chunks_written += 1
        report.bytes_serialized += len(edit.data)
        report.bytes_hashed += len(edit.data)
        records[idx] = TensorRecord(rec.name, rec.shape, rec.dtype,
                                    rec.chunk_bytes, tuple(chunks), fp=fp)
    layer.records = records
    layer.checksum = content_checksum(records)   # O(#chunks) metadata hash
    report.layers_injected += 1
    return layer


def inject_image_multi(store: LayerStore,
                       name: str, tag: str, new_tag: str,
                       diffs: Dict[str, LayerDiff],
                       providers: Optional[Dict[str, Callable[
                           [], Dict[str, torch.Tensor]]]] = None,
                       *, durability: Optional[str] = "batch",
                       ) -> Tuple[Manifest, ImageConfig, BuildReport]:
    """Batched multi-layer injection (see module docstring): validate all,
    clone+inject all targeted layers up front, then ONE downstream re-key
    walk and ONE manifest/config commit. ``diffs`` keyed by layer_id.

    ``durability``: mode for this transaction's blob/layer writes —
    "batch" (default: one concurrent fsync flush at the commit point),
    "full", or None to keep the store's own mode.
    """
    with span("store.inject") as sp:
        out = _inject_image_multi(store, name, tag, new_tag, diffs,
                                  providers, durability)
        sp.set(chunks=out[2].chunks_written, bytes_hashed=out[2].bytes_hashed,
               bytes_written=out[2].bytes_serialized)
    return out


def _inject_image_multi(store: LayerStore, name: str, tag: str, new_tag: str,
                        diffs: Dict[str, LayerDiff], providers,
                        durability: Optional[str]
                        ) -> Tuple[Manifest, ImageConfig, BuildReport]:
    report = BuildReport()
    t0 = time.perf_counter()
    fsyncs0, commits0 = store.fsyncs, store.commits
    manifest, config = store.read_image(name, tag)
    layers = [store.read_layer(lid) for lid in manifest.layer_ids]
    by_id = {layer.layer_id: layer for layer in layers}

    # Validate the WHOLE batch before any write hits the store.
    live: Dict[str, LayerDiff] = {}
    for lid, diff in diffs.items():
        if diff.is_empty:
            continue
        layer = by_id.get(lid)
        if layer is None:
            raise KeyError(f"layer {lid} is not part of {name}:{tag}")
        if layer.empty:
            raise StructureChangeError(
                f"layer {lid} ({layer.instruction.text}): config layers "
                "take the normal empty-layer rebuild path, not injection")
        if not diff.injectable:
            raise StructureChangeError(
                f"layer {lid} ({layer.instruction.text}): structure change")
        live[lid] = diff

    # Still pre-write: resolve the walk's Scenario-4 derivation cascade
    # ONCE (derives_from is static metadata), so a missing provider aborts
    # before any blob exists and Phase B just consumes the plan.
    will_change: set = set()
    rederive_ids: set = set()
    for layer in layers:
        ins = layer.instruction
        if layer.layer_id in live:
            will_change.add(ins.arg)
        elif ins.op == "RUN" and not layer.empty and \
                any(dep in will_change for dep in ins.derives_from):
            if providers is None or ins.arg not in providers:
                raise StructureChangeError(
                    f"layer {layer.layer_id} derives from injected payload "
                    f"but no provider given to re-derive it")
            rederive_ids.add(layer.layer_id)
            will_change.add(ins.arg)

    with _durability_scope(store, durability):
        # Phase A — C4+C2: clone every targeted layer up front and write
        # only the changed chunk blobs into the clones.
        clones: Dict[str, LayerDescriptor] = {}
        for lid, diff in live.items():
            entry = report.layer_entry(lid)
            chunks0, bytes0 = report.chunks_written, report.bytes_serialized
            clones[lid] = apply_edits(store, clone_layer(by_id[lid]), diff,
                                      report)
            entry["chunks_written"] += report.chunks_written - chunks0
            entry["bytes_written"] += report.bytes_serialized - bytes0

        # Phase B — C3: the single downstream re-key walk, consuming the
        # pre-resolved derivation plan (rederive_ids). ``delta`` records
        # this commit's replication unit (the format of the JAX package's
        # core/delta.py): old->new layer maps by change kind plus the
        # chunk ids written.
        report.rekey_walks += 1
        delta = {"base": [name, tag], "injected": {}, "rederived": {},
                 "rekeyed": {}}
        delta_chunks = {e.new_hash for d in live.values() for e in d.edits}
        new_layers: List[LayerDescriptor] = []
        parent_chain: Optional[str] = None
        dirty = False   # once any upstream id changed, downstream re-keys
        for layer in layers:
            ins = layer.instruction
            clone = clones.get(layer.layer_id)
            if clone is not None:
                clone.chain = chain_checksum(parent_chain, clone.checksum,
                                             ins.text)
                store.write_layer(clone)
                new_layers.append(clone)
                delta["injected"][clone.layer_id] = layer.layer_id
                dirty = True
            elif layer.layer_id in rederive_ids:
                # Scenario-4: a derived layer re-runs its derivation — once
                # per batch, no matter how many upstream injections hit it.
                entry = report.layer_entry(layer.layer_id)
                chunks0 = report.chunks_written
                bytes0 = report.bytes_serialized
                payload = providers[ins.arg]()
                report.derivations_run += 1
                rebuilt = store.build_content_layer(
                    ins, payload, parent_chain, report,
                    family=layer.family, version=layer.version + 1)
                entry["rederived"] += 1
                entry["chunks_written"] += report.chunks_written - chunks0
                entry["bytes_written"] += report.bytes_serialized - bytes0
                new_layers.append(rebuilt)
                delta["rederived"][rebuilt.layer_id] = layer.layer_id
                delta_chunks.update(h for rec in rebuilt.records
                                    for h in rec.chunks)
                dirty = True
            elif dirty:
                # Downstream of a change: RE-KEY only (chain checksum),
                # never re-serialize — Docker's fall-through replaced.
                rekeyed = clone_layer(layer)
                rekeyed.chain = chain_checksum(parent_chain,
                                               rekeyed.checksum, ins.text)
                store.write_layer(rekeyed)
                new_layers.append(rekeyed)
                delta["rekeyed"][rekeyed.layer_id] = layer.layer_id
                report.layers_rekeyed += 1
                report.layer_entry(layer.layer_id)["rekeyed"] += 1
            else:
                new_layers.append(layer)
                report.layers_cached += 1
            parent_chain = new_layers[-1].chain

        # Phase C — ONE manifest/config commit (the crash-safety point).
        # History is capped: the config is copied forward and re-fsynced on
        # every commit, so an unbounded audit trail would quietly turn the
        # O(delta) save into O(total saves) of config serialization.
        # The chunk-id list in the history record is CAPPED: the config is
        # copied forward and re-fsync'd on every commit, so a save touching
        # thousands of chunks must not turn the audit trail into megabytes
        # of hashes x 64 retained entries. n_chunks always has the truth.
        delta["n_chunks"] = len(delta_chunks)
        delta["chunks"] = sorted(delta_chunks)[:_DELTA_CHUNKS_CAP]
        total_edits = sum(len(d.edits) for d in live.values())
        history = (config.history +
                   [injection_history_entry(report.per_layer, total_edits,
                                            delta=delta)])[-_HISTORY_CAP:]
        new_config = ImageConfig(
            config_id=new_uuid(), arch=config.arch,
            version=config.version + 1,
            layer_checksums={l.layer_id: l.checksum for l in new_layers},
            layer_chains={l.layer_id: l.chain for l in new_layers},
            history=history,
        )
        new_manifest = Manifest(name=name, tag=new_tag,
                                layer_ids=[l.layer_id for l in new_layers],
                                config_id=new_config.config_id)
        with span("store.flush") as sp:
            f0 = store.fsyncs
            store.write_image(new_manifest, new_config)
            sp.set(fsyncs=store.fsyncs - f0)

    report.fsyncs = store.fsyncs - fsyncs0
    report.manifest_commits = store.commits - commits0
    report.chunks_prefiltered = sum(d.chunks_prefiltered
                                    for d in diffs.values())
    report.wall_seconds = time.perf_counter() - t0
    return new_manifest, new_config, report


def inject_image(store: LayerStore,
                 name: str, tag: str, new_tag: str,
                 diffs: Dict[str, LayerDiff],
                 providers: Optional[Dict[str, Callable[
                     [], Dict[str, torch.Tensor]]]] = None,
                 ) -> Tuple[Manifest, ImageConfig, BuildReport]:
    """Seed-compatible single-transaction API: the same pipeline under the
    store's own durability mode (batch by default store-wide; a store
    opened with durability="full" keeps its per-write fsync accounting)."""
    return inject_image_multi(store, name, tag, new_tag, diffs, providers,
                              durability=None)


def inject_payload_update(store: LayerStore, name: str, tag: str,
                          new_tag: str,
                          payloads: Dict[str, Dict[str, torch.Tensor]],
                          providers=None,
                          ) -> Tuple[Manifest, ImageConfig, BuildReport]:
    """Convenience: C1 (host diff) + full injection for new payload values.

    ``payloads`` maps instruction arg (payload key) -> new payload dict.
    """
    manifest, _ = store.read_image(name, tag)
    layers = [store.read_layer(lid) for lid in manifest.layer_ids]
    diffs = diff_image(layers, payloads)
    return inject_image(store, name, tag, new_tag, diffs, providers)
