"""LayerStore — the on-disk content-addressed layer store (torch port of
the part of ``repro/core/store.py`` that saving and serving use: blobs,
layers, images and tags, batch durability, ``build_image`` with the DLC
cache rules, payload loading and ``verify_image``). The format on disk is
byte-identical to the JAX package's.

Layout (mirrors /var/lib/docker/overlay2 + image metadata):

    <root>/blobs/sha256/<h[:2]>/<h>     chunk payloads (dedup'd by content)
    <root>/layers/<layer_uuid>.json     LayerDescriptor
    <root>/images/<name>/<tag>.json     Manifest
    <root>/images/<name>/<config>.json  ImageConfig

All metadata writes are atomic (tmp + os.replace) so a crash mid-save never
leaves a referenced-but-corrupt image — the commit point is the manifest
rename. Blobs are immutable once written (content-addressed), which is what
makes clone-before-inject (C4) O(#chunk-refs) instead of O(bytes).

``build_image`` is the **Docker-faithful baseline** including the DLC cache
rules of paper §II.A:
  1. identical chain -> skip entirely ("Using cache"),
  2. instruction added/removed/altered -> rebuild that layer,
  3. COPY/ADD: compare the new payload's *content* against the cached
     layer — answered by the per-chunk fingerprint sidecar when present
     (one vectorized pass, ``BuildReport.chunks_prefiltered``; any
     fingerprint mismatch proves a miss, all-equal is taken as a hit),
     else by the full re-chunk + re-SHA the real Docker pays,
  4. RUN/CMD/ENV: compare the *literal instruction text* only,
and the fall-through rule: the first rebuilt layer invalidates every layer
after it (chain checksums force re-execution of all downstream builds).

I/O accounting: every fsync (file or directory) is counted in
``LayerStore.fsyncs`` and surfaced per build via ``BuildReport.fsyncs``;
``durability="batch"`` (see LayerStore) defers per-chunk fsyncs to one
concurrent flush at the manifest commit point.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .chunker import (DEFAULT_CHUNK_BYTES, TensorRecord, assemble_tensor,
                      chunk_tensor, dtype_str, sha256_hex, shape_of)
from .fingerprint import fingerprint_tree_packed
from .manifest import (ImageConfig, Instruction, LayerDescriptor, Manifest,
                       chain_checksum, content_checksum, dumps, new_uuid)

_HEX_ID = re.compile(r"[0-9a-f]{32}|[0-9a-f]{64}")  # uuid4.hex / sha256 hex

# Directory fsyncs at the batch-durability commit point are independent
# blocking syscalls — issue them concurrently.
_IO_POOL_WORKERS = min(4, os.cpu_count() or 1)
_IO_POOL: Optional[object] = None
_IO_POOL_LOCK = threading.Lock()


def _io_pool():
    global _IO_POOL
    with _IO_POOL_LOCK:
        if _IO_POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _IO_POOL = ThreadPoolExecutor(max_workers=_IO_POOL_WORKERS,
                                          thread_name_prefix="repro-torch-fsync")
    return _IO_POOL


def _atomic_write(path: str, data, fsync: bool = True) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{time.monotonic_ns()}"
    with open(tmp, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_path(path: str) -> None:
    """fsync a file's data or a directory's entries (missing paths are
    ignored)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except FileNotFoundError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclass
class BuildReport:
    """What a build actually did — benchmarks read these counters."""

    layers_built: int = 0
    layers_cached: int = 0
    layers_injected: int = 0
    layers_rekeyed: int = 0
    bytes_serialized: int = 0
    bytes_hashed: int = 0
    chunks_written: int = 0
    derivations_run: int = 0
    bytes_d2h: int = 0           # device->host traffic (fingerprint tables)
    chunks_prefiltered: int = 0  # chunks skipped via fingerprint prefilter
    fsyncs: int = 0              # fsync syscalls issued (files + dirs)
    rekey_walks: int = 0         # downstream chain-re-key walks performed
    manifest_commits: int = 0    # write_image commit points hit
    wall_seconds: float = 0.0
    # Per-layer cost attribution, keyed by the SOURCE image's layer_id
    # (the id the caller's diffs/providers are keyed by). Each entry:
    # {"chunks_written", "bytes_written", "rekeyed", "rederived"}.
    per_layer: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def layer_entry(self, layer_id: str) -> Dict[str, int]:
        return self.per_layer.setdefault(
            layer_id, {"chunks_written": 0, "bytes_written": 0,
                       "rekeyed": 0, "rederived": 0})


class LayerStore:
    """See module docstring. ``durability``:

    * ``"batch"`` (the default) — blob/layer writes skip the inline
      per-file fsync; at the commit point (``write_image``, before the
      manifest rename) the dirty FILES are fsync'd concurrently in one
      deferred batch, then their directories. Durability is equivalent to
      "full" once the manifest is visible — the fsyncs are deferred and
      overlapped, not skipped. The manifest rename remains the commit
      point, so a crash mid-save still leaves the previous image intact.
    * ``"full"``  — every blob/layer write is fsync'd before it is linked
      in (the seed behavior; one fsync per chunk). Only useful when a
      caller needs every write durable BEFORE a commit point exists —
      e.g. writing blobs it never intends to commit under a manifest.

    Every TensorRecord it builds carries the per-chunk fingerprint sidecar
    (excluded from content checksums) that the COPY-cache prefilter of
    ``build_image`` reads; records without one (from a store written with
    the JAX package's ``record_fingerprints=False``) are still read.
    """

    def __init__(self, root: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 durability: str = "batch"):
        if durability not in ("full", "batch"):
            raise ValueError(f"unknown durability mode {durability!r}")
        self.root = root
        self.chunk_bytes = chunk_bytes
        self.durability = durability
        self.fsyncs = 0              # lifetime fsync count (files + dirs)
        self.commits = 0             # lifetime write_image commit count
        self._dirty_dirs: set = set()
        self._dirty_files: set = set()
        # paths this process knows are durable (fsync'd inline or at a
        # commit). A dedup hit on a path NOT in this set may be a torn
        # leftover of a crashed batch-mode save — batch mode re-fsyncs it
        # at the next commit instead of trusting bare existence.
        self._durable_paths: set = set()
        self._dirty_lock = threading.Lock()
        # Layer descriptors are immutable once written (every revision gets
        # a fresh layer_id), so parsed descriptors are cached: the
        # incremental save path re-reads every layer of the parent image on
        # each save, and a 100+-record descriptor costs milliseconds to
        # re-parse. Bounded FIFO; blobs/manifests are NOT cached.
        self._layer_cache: "dict[str, LayerDescriptor]" = {}
        self._layer_cache_cap = 512
        # Tag listings are re-requested on every save (latest_step) but only
        # change at a manifest commit — cache per image name, invalidated
        # there.
        self._tags_cache: Dict[str, List[str]] = {}
        for sub in ("blobs/sha256", "layers", "images"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)

    # ------------------------------------------------------------ durability
    def _write_file(self, path: str, data) -> None:
        full = self.durability == "full"
        _atomic_write(path, data, fsync=full)
        if full:
            self.fsyncs += 1
            self._durable_paths.add(path)
        else:
            with self._dirty_lock:
                self._dirty_files.add(path)
                self._dirty_dirs.add(os.path.dirname(path))

    def sync_for_commit(self) -> None:
        """Flush deferred durability: fsync every dirty file's data, then
        every dirty directory, each batch issued concurrently (independent
        syscalls — wall time is the slowest sync, not the sum). Called
        automatically by ``write_image`` (the commit point)."""
        with self._dirty_lock:
            files, self._dirty_files = self._dirty_files, set()
            dirs, self._dirty_dirs = self._dirty_dirs, set()
        for batch in (sorted(files), sorted(dirs)):
            if not batch:
                continue
            if len(batch) > 1 and _IO_POOL_WORKERS > 1:
                list(_io_pool().map(_fsync_path, batch))
            else:
                for p in batch:
                    _fsync_path(p)
            self.fsyncs += len(batch)
        self._durable_paths.update(files)

    # ---------------------------------------------------------------- blobs
    def _blob_path(self, h: str) -> str:
        d = os.path.join(self.root, "blobs", "sha256", h[:2])
        return os.path.join(d, h)

    def has_blob(self, h: str) -> bool:
        return os.path.exists(self._blob_path(h))

    def write_blob(self, h: str, data) -> bool:
        """Returns True if a new blob was written (False = dedup hit)."""
        path = self._blob_path(h)
        if os.path.exists(path):
            if self.durability == "batch" and path not in self._durable_paths:
                # existence alone doesn't prove durability: this could be
                # the un-fsynced leftover of a crashed batch-mode save —
                # re-fsync it at the next commit before referencing it
                with self._dirty_lock:
                    self._dirty_files.add(path)
                    self._dirty_dirs.add(os.path.dirname(path))
            return False
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._write_file(path, data)
        return True

    def read_blob(self, h: str) -> bytes:
        with open(self._blob_path(h), "rb") as f:
            return f.read()

    # --------------------------------------------------------------- layers
    def _layer_path(self, layer_id: str) -> str:
        return os.path.join(self.root, "layers", f"{layer_id}.json")

    def _cache_layer(self, layer: LayerDescriptor) -> None:
        if len(self._layer_cache) >= self._layer_cache_cap:
            self._layer_cache.pop(next(iter(self._layer_cache)))
        self._layer_cache[layer.layer_id] = layer

    def write_layer(self, layer: LayerDescriptor) -> None:
        self._write_file(self._layer_path(layer.layer_id),
                         dumps(layer.to_json()).encode())
        self._cache_layer(layer)

    def read_layer(self, layer_id: str, use_cache: bool = True
                   ) -> LayerDescriptor:
        if use_cache:
            cached = self._layer_cache.get(layer_id)
            if cached is not None:
                return cached
        with open(self._layer_path(layer_id), "rb") as f:
            layer = LayerDescriptor.from_json(json.loads(f.read()))
        self._cache_layer(layer)
        return layer

    def has_layer(self, layer_id: str) -> bool:
        return os.path.exists(self._layer_path(layer_id))

    # --------------------------------------------------------------- images
    def _image_dir(self, name: str) -> str:
        d = os.path.join(self.root, "images", name)
        os.makedirs(d, exist_ok=True)
        return d

    def write_image(self, manifest: Manifest, config: ImageConfig) -> None:
        d = self._image_dir(manifest.name)
        # Commit point: flush any deferred (durability="batch") blob/layer
        # writes before the manifest becomes visible, then write config +
        # manifest fully synced regardless of durability mode.
        self.sync_for_commit()
        _atomic_write(os.path.join(d, f"{config.config_id}.json"),
                      dumps(config.to_json()).encode())
        # Manifest rename is the commit point.
        _atomic_write(os.path.join(d, f"{manifest.tag}.json"),
                      dumps(manifest.to_json()).encode())
        self.fsyncs += 2
        self.commits += 1
        self._tags_cache.pop(manifest.name, None)

    def read_image(self, name: str, tag: str) -> Tuple[Manifest, ImageConfig]:
        d = self._image_dir(name)
        with open(os.path.join(d, f"{tag}.json"), "rb") as f:
            manifest = Manifest.from_json(json.loads(f.read()))
        with open(os.path.join(d, f"{manifest.config_id}.json"), "rb") as f:
            config = ImageConfig.from_json(json.loads(f.read()))
        return manifest, config

    def has_image(self, name: str, tag: str) -> bool:
        return os.path.exists(os.path.join(self.root, "images", name, f"{tag}.json"))

    def list_tags(self, name: str, fresh: bool = False) -> List[str]:
        """``fresh=True`` bypasses the commit-point cache — required when
        ANOTHER process/store instance may have committed tags (the cache
        is only invalidated by this instance's own write_image)."""
        cached = None if fresh else self._tags_cache.get(name)
        if cached is not None:
            return list(cached)
        d = os.path.join(self.root, "images", name)
        if not os.path.isdir(d):
            return []
        # Skip config blobs explicitly: their filenames are bare hex ids
        # (32-hex uuid4 / 64-hex sha256), never user tags.
        tags = sorted(stem for stem in (p[:-5] for p in os.listdir(d)
                                        if p.endswith(".json"))
                      if not _HEX_ID.fullmatch(stem))
        self._tags_cache[name] = tags
        return list(tags)

    # ------------------------------------------------------------ build API
    def build_content_layer(self, instruction: Instruction,
                            payload: Dict[str, torch.Tensor],
                            parent_chain: Optional[str],
                            report: BuildReport,
                            family: Optional[str] = None,
                            version: int = 1) -> LayerDescriptor:
        """Full (baseline) layer build: serialize + hash EVERY byte. The
        fingerprint sidecars of the whole layer come from one
        ``fingerprint_tree_packed`` call, on the device holding the leaves
        (one kernel launch per content layer on the card)."""
        import dataclasses

        fps = fingerprint_tree_packed(payload, self.chunk_bytes)
        records: List[TensorRecord] = []
        for name in sorted(payload.keys()):
            # one D2H copy per tensor
            rec, pairs = chunk_tensor(name, payload[name], self.chunk_bytes)
            for h, piece in pairs:
                if self.write_blob(h, piece):
                    report.chunks_written += 1
                report.bytes_hashed += len(piece)
            report.bytes_serialized += rec.nbytes
            rec = dataclasses.replace(
                rec, fp=tuple((int(a), int(b)) for a, b in fps[name].tolist()))
            records.append(rec)
        checksum = content_checksum(records)
        lid = new_uuid()     # fresh descriptor identity per revision
        layer = LayerDescriptor(
            layer_id=lid,
            version=version,
            instruction=instruction,
            checksum=checksum,
            chain=chain_checksum(parent_chain, checksum, instruction.text),
            records=records,
            empty=False,
            family=family or lid,
        )
        self.write_layer(layer)
        report.layers_built += 1
        return layer

    def build_config_layer(self, instruction: Instruction,
                           parent_chain: Optional[str],
                           report: BuildReport,
                           family: Optional[str] = None,
                           version: int = 1) -> LayerDescriptor:
        """Empty layer — paper §III.B: config layers are 'empty layers' whose
        rebuild does not change content checksums."""
        checksum = content_checksum([])
        lid = new_uuid()
        layer = LayerDescriptor(
            layer_id=lid,
            version=version,
            instruction=instruction,
            checksum=checksum,
            chain=chain_checksum(parent_chain, checksum, instruction.text),
            records=[],
            empty=True,
            family=family or lid,
        )
        self.write_layer(layer)
        report.layers_built += 1
        return layer

    def _copy_payload_matches(self, prev: LayerDescriptor,
                              payload: Dict[str, torch.Tensor],
                              report: BuildReport) -> bool:
        """COPY/ADD cache check. Prefers the per-chunk fingerprint sidecar:
        any fingerprint mismatch proves the bytes changed (definite cache
        miss, no hashing at all); all-equal fingerprints are taken as a hit
        (a 64-bit prefilter — the same collision budget the incremental
        save path already accepts). Records without a sidecar use the seed
        behavior: full re-chunk + re-SHA of the payload.
        """
        by_name = {r.name: r for r in prev.records}
        if set(by_name) != set(payload):
            return False
        if prev.records and all(r.fp is not None for r in prev.records):
            candidate_chunks = 0
            for pname, rec in by_name.items():
                arr = payload[pname]
                if shape_of(arr) != rec.shape or dtype_str(arr) != rec.dtype:
                    return False
            # one fingerprint pass per chunk size (normally one)
            for cb in sorted({rec.chunk_bytes for rec in prev.records}):
                new_fps = fingerprint_tree_packed(
                    {n: payload[n] for n, r in by_name.items()
                     if r.chunk_bytes == cb}, cb)
                for pname, new_fp in new_fps.items():
                    rec = by_name[pname]
                    if tuple((int(a), int(b)) for a, b in new_fp.tolist()) \
                            != rec.fp:
                        return False    # definite miss: full rebuild follows
                    candidate_chunks += len(rec.chunks)
            # only a HIT skipped work — count prefiltered chunks here, not
            # on the miss path where everything gets re-serialized anyway
            report.chunks_prefiltered += candidate_chunks
            return True
        recs = []
        for pname in sorted(payload.keys()):
            rec, pairs = chunk_tensor(pname, payload[pname],
                                      self.chunk_bytes)
            report.bytes_hashed += sum(len(p) for _, p in pairs)
            recs.append(rec)
        return content_checksum(recs) == prev.checksum

    def build_image(self, name: str, tag: str,
                    instructions: Sequence[Instruction],
                    providers: Dict[str, Callable[[], Dict[str, torch.Tensor]]],
                    parent: Optional[Tuple[str, str]] = None,
                    arch: str = "generic") -> Tuple[Manifest, ImageConfig, BuildReport]:
        """Docker-faithful build with DLC caching + fall-through.

        ``providers[arg]()`` materializes the payload for a content
        instruction (the analogue of reading build-context files for COPY or
        executing a RUN). For RUN instructions the provider is the
        *derivation* — it is re-executed on every rebuild, which is exactly
        the fall-through cost the paper attacks.
        """
        report = BuildReport()
        t0 = time.perf_counter()
        fsyncs0, commits0 = self.fsyncs, self.commits
        parent_layers: List[LayerDescriptor] = []
        if parent is not None and self.has_image(*parent):
            pm, _ = self.read_image(*parent)
            parent_layers = [self.read_layer(lid) for lid in pm.layer_ids]

        layer_ids: List[str] = []
        checksums: Dict[str, str] = {}
        chains: Dict[str, str] = {}
        history: List[dict] = []
        parent_chain: Optional[str] = None
        fell_through = False

        for i, ins in enumerate(instructions):
            prev = parent_layers[i] if i < len(parent_layers) else None
            use_cache = False
            if prev is not None and not fell_through:
                if prev.instruction.text != ins.text:
                    use_cache = False          # DLC rule 2: instruction altered
                elif ins.kind == "config":
                    use_cache = True           # DLC rule 4: literal text match
                elif ins.op in ("COPY", "ADD"):
                    # DLC rule 3: the NEW payload's content must be compared
                    # against the cached layer. When the cached records
                    # carry a fingerprint sidecar, a cache HIT costs one
                    # vectorized fingerprint pass (no chunk copy, no SHA);
                    # otherwise fall back to the Docker-faithful full
                    # serialize+hash of the build context.
                    payload = providers[ins.arg]()
                    use_cache = self._copy_payload_matches(prev, payload,
                                                           report)
                else:
                    # RUN: literal text only (rule 4) — Docker does NOT
                    # re-execute to compare outputs.
                    use_cache = True

            if use_cache and prev is not None:
                layer = prev
                # Chain must still be re-validated against the (possibly
                # rebuilt) parent; identical prefix keeps identical chains.
                expected_chain = chain_checksum(parent_chain, layer.checksum,
                                                ins.text)
                if expected_chain != layer.chain:
                    use_cache = False
                else:
                    report.layers_cached += 1

            if not (use_cache and prev is not None):
                fell_through = True            # everything below rebuilds
                if ins.kind == "config":
                    layer = self.build_config_layer(
                        ins, parent_chain, report,
                        family=prev.family if prev else None,
                        version=(prev.version + 1) if prev else 1)
                else:
                    payload = providers[ins.arg]()
                    if ins.op == "RUN":
                        report.derivations_run += 1
                    layer = self.build_content_layer(
                        ins, payload, parent_chain, report,
                        family=prev.family if prev else None,
                        version=(prev.version + 1) if prev else 1)

            layer_ids.append(layer.layer_id)
            checksums[layer.layer_id] = layer.checksum
            chains[layer.layer_id] = layer.chain
            history.append({"instruction": ins.text, "layer": layer.layer_id,
                            "cached": bool(use_cache and prev is not None)})
            parent_chain = layer.chain

        config = ImageConfig(config_id=new_uuid(), arch=arch, version=1,
                             layer_checksums=checksums, layer_chains=chains,
                             history=history)
        manifest = Manifest(name=name, tag=tag, layer_ids=layer_ids,
                            config_id=config.config_id)
        self.write_image(manifest, config)
        report.fsyncs = self.fsyncs - fsyncs0
        report.manifest_commits = self.commits - commits0
        report.wall_seconds = time.perf_counter() - t0
        return manifest, config, report

    # ------------------------------------------------------------- load API
    def load_image_payload(self, name: str, tag: str,
                           names: Optional[Sequence[str]] = None
                           ) -> Dict[str, torch.Tensor]:
        """Assemble an image's tensors from their chunk blobs. ``names``
        restricts assembly to those tensors (the sparse-refresh path:
        O(changed tensors) of blob reads instead of O(image)); None loads
        everything."""
        manifest, _ = self.read_image(name, tag)
        want = None if names is None else set(names)
        out: Dict[str, torch.Tensor] = {}
        for lid in manifest.layer_ids:
            layer = self.read_layer(lid)
            if layer.empty:
                continue
            for r in layer.records:
                if want is None or r.name in want:
                    out[r.name] = assemble_tensor(r, self.read_blob)
        return out

    # ---------------------------------------------------------- verification
    def verify_image(self, name: str, tag: str, deep: bool = True) -> List[str]:
        """Integrity check — the test C3 must bypass. Returns problems."""
        problems: List[str] = []
        manifest, config = self.read_image(name, tag)
        parent_chain: Optional[str] = None
        for lid in manifest.layer_ids:
            if not self.has_layer(lid):
                problems.append(f"missing layer {lid}")
                continue
            # integrity checks must look at the bytes on DISK, not the cache
            layer = self.read_layer(lid, use_cache=False)
            if content_checksum(layer.records) != layer.checksum:
                problems.append(f"layer {lid}: content checksum mismatch")
            if config.layer_checksums.get(lid) != layer.checksum:
                problems.append(f"layer {lid}: config lock mismatch")
            expected_chain = chain_checksum(parent_chain, layer.checksum,
                                            layer.instruction.text)
            if expected_chain != layer.chain or \
               config.layer_chains.get(lid) != layer.chain:
                problems.append(f"layer {lid}: chain mismatch")
            if deep and not layer.empty:
                for rec in layer.records:
                    for h in rec.chunks:
                        if not self.has_blob(h):
                            problems.append(f"layer {lid}: missing blob {h[:12]}")
                        elif sha256_hex(self.read_blob(h)) != h:
                            problems.append(f"layer {lid}: corrupt blob {h[:12]}")
            parent_chain = layer.chain
        return problems
