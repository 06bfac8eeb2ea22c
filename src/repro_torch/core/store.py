"""LayerStore — the on-disk content-addressed layer store (torch port of
``repro/core/store.py``: blobs, layers, images and tags, batch durability,
``build_image`` with the DLC cache rules, payload loading,
``verify_image``, the resumable at-rest ``scrub``, the cross-image
holdings index the delta registry negotiates against, retention leases,
quarantine, repair pinning, ``remove_image`` with the mark-and-sweep
``gc`` and its hooks, and ``export_image``/``import_image`` bundles). The
format on disk is byte-identical to the JAX package's, quarantine
directory and scrub cursor included, and so is an exported bundle; leases
and the holdings index live in memory, per store instance, as in the
reference.

Layout (mirrors /var/lib/docker/overlay2 + image metadata):

    <root>/blobs/sha256/<h[:2]>/<h>     chunk payloads (dedup'd by content)
    <root>/layers/<layer_uuid>.json     LayerDescriptor
    <root>/images/<name>/<tag>.json     Manifest
    <root>/images/<name>/<config>.json  ImageConfig
    <root>/quarantine/<h>               corrupt blobs moved aside
    <root>/scrub.cursor.json            next blob shard of a sliced scrub

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

import io
import json
import os
import re
import tarfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ft.faults import CrashInjected, fault_point
from ..ft.scrub import (N_SHARDS, ScrubFinding, ScrubReport, clear_cursor,
                        load_cursor, save_cursor)
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
class HoldingsIndex:
    """The store's committed holdings across EVERY image — the cross-image
    blob universe the delta registry negotiates against (built by
    ``LayerStore.holdings_index``).

    * ``committed_layers`` — every layer id reachable from ANY committed
      tag of ANY image. This is the trust boundary: "held" at this store
      means a member of this set; a descriptor file outside it is an
      orphan of a crashed push and must never vouch for anything.
    * ``by_family`` — ``(family, content_checksum) -> layer_id`` over the
      per-image tag window: the re-key table's lookup side. The twin may
      live under a DIFFERENT image name than the one being pushed —
      content-checksum equality over the chunk-hash list is what proves
      the blobs present, not the image namespace.
    * ``known_chunks`` — chunk ids referenced by the window-scanned
      committed layers: membership means present AND verified by the push
      that committed them, whatever image that was.
    * ``images`` — the image names scanned (diagnostics / accounting).
    """

    committed_layers: set = field(default_factory=set)
    by_family: Dict[Tuple[str, str], str] = field(default_factory=dict)
    known_chunks: set = field(default_factory=set)
    images: List[str] = field(default_factory=list)


@dataclass
class _HoldingsAux:
    """Refcount bookkeeping that makes a cached ``HoldingsIndex``
    incrementally maintainable (one aux per cached tag window).

    The index's sets are membership views over these counts: a layer id is
    committed while ``layer_refs > 0`` (summed over every (image, tag)
    that references it), a chunk is known while ``chunk_refs > 0`` (summed
    over the *windowed* layers that reference it), and the re-key table
    maps a ``(family, checksum)`` key to the lexicographically smallest of
    its live windowed members — so adds and subtracts commute and a
    remove+gc can never leave the index vouching for a swept blob.
    ``win_added`` records, per windowed (image, tag), exactly the layer
    ids whose chunks were indexed (a missing descriptor is skipped at add
    time, so subtraction must not guess). Any inconsistency — an
    unreadable descriptor at subtract time, an underflowing count, a tag
    overwrite — invalidates the whole cache entry and the next
    ``holdings_index`` call falls back to the full rebuild (the cold-start
    / repair path).
    """

    layer_refs: Dict[str, int] = field(default_factory=dict)
    win_layer_refs: Dict[str, int] = field(default_factory=dict)
    chunk_refs: Dict[str, int] = field(default_factory=dict)
    family_members: Dict[Tuple[str, str], set] = field(default_factory=dict)
    win_tags: Dict[str, List[str]] = field(default_factory=dict)
    win_added: Dict[Tuple[str, str], List[str]] = field(default_factory=dict)


class _HoldingsStale(Exception):
    """Internal: the incremental holdings update hit a case it cannot
    apply soundly — drop the cache entry, rebuild lazily."""


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

    _COUNTERS = ("layers_built", "layers_cached", "layers_injected",
                 "layers_rekeyed", "bytes_serialized", "bytes_hashed",
                 "chunks_written", "derivations_run", "bytes_d2h",
                 "chunks_prefiltered", "fsyncs", "rekey_walks",
                 "manifest_commits")

    def layer_entry(self, layer_id: str) -> Dict[str, int]:
        return self.per_layer.setdefault(
            layer_id, {"chunks_written": 0, "bytes_written": 0,
                       "rekeyed": 0, "rederived": 0})

    def merge(self, other: "BuildReport") -> None:
        for k in self._COUNTERS:
            setattr(self, k, getattr(self, k) + getattr(other, k))
        for lid, entry in other.per_layer.items():
            mine = self.layer_entry(lid)
            for k, v in entry.items():
                mine[k] = mine.get(k, 0) + v
        self.wall_seconds += other.wall_seconds


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
        # gc() callbacks for state that references committed tags but lives
        # OUTSIDE the marked namespace (e.g. a PassiveRegistry's published
        # bundles) — each returns {stat: count} merged into the gc stats.
        self._gc_hooks: "list" = []
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
        # Cross-image holdings index (see holdings_index): rebuilt lazily,
        # then maintained INCREMENTALLY at the two points that change
        # committed reachability — write_image applies the new manifest's
        # layer set, remove_image subtracts it (refcounted via
        # _HoldingsAux; any case the incremental path cannot apply soundly
        # drops the entry and the next call rebuilds). Keyed by the tag
        # window so receivers with different windows never share an entry.
        self._holdings_cache: Dict[int, "HoldingsIndex"] = {}
        self._holdings_aux: Dict[int, _HoldingsAux] = {}
        self._holdings_lock = threading.Lock()
        # Blob/layer paths pinned by an in-progress RepairSession
        # (core/registry.py): a quarantined-then-refetched layer descriptor
        # leaves gc()'s mark phase blind to the blobs it references, so the
        # session registers every path the damaged image reaches here and
        # gc's sweep spares them — the same exemption the batch-durability
        # dirty set gets. Guarded by _dirty_lock (gc snapshots both
        # together).
        self._protected_paths: set = set()
        # Retention leases: (name, tag) -> {owner: expiry (monotonic)}.
        # A relay fanning a delta to lagging children takes a lease on the
        # tags whose blobs those children may still need; retention
        # (remove_image via ckpt.prune_steps) refuses to collect a leased
        # tag until every lease is released (child committed) or expired
        # (child died). gc() is lease-safe transitively: it only sweeps
        # what no tagged manifest reaches, and the leased tag's manifest
        # stays. In-memory by design — leases protect in-flight fan-outs
        # of THIS process; a crashed relay's leases die with it, exactly
        # the expiry semantics a restart wants.
        self._leases: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._lease_lock = threading.Lock()
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

    # ---------------------------------------------------------------- leases
    def acquire_lease(self, name: str, tag: str, owner: str,
                      ttl_s: float) -> None:
        """Hold ``name:tag`` against retention for ``ttl_s`` seconds on
        behalf of ``owner``. Ref-counted by owner; re-acquiring refreshes
        the expiry (a retried push extends its children's leases)."""
        with self._lease_lock:
            self._leases.setdefault((name, tag), {})[owner] = \
                time.monotonic() + ttl_s

    def release_lease(self, name: Optional[str], owner: str,
                      tag: Optional[str] = None) -> int:
        """Release ``owner``'s lease on ``tag`` (or on every tag of
        ``name`` when tag is None — the child-committed case; or on every
        tag of EVERY image when name is None too — a relay whose child
        committed releases the whole cross-image base set it pinned at
        negotiate). Returns the number of leases released."""
        n = 0
        with self._lease_lock:
            for (nm, tg), owners in list(self._leases.items()):
                if (name is not None and nm != name) or \
                        (tag is not None and tg != tag):
                    continue
                if owners.pop(owner, None) is not None:
                    n += 1
                if not owners:
                    del self._leases[(nm, tg)]
        return n

    def lease_holders(self, name: str, tag: str) -> List[str]:
        """Owners with an unexpired lease on ``name:tag`` (expired entries
        are purged here — expiry needs no background thread)."""
        now = time.monotonic()
        with self._lease_lock:
            owners = self._leases.get((name, tag))
            if not owners:
                return []
            live = {o: exp for o, exp in owners.items() if exp > now}
            if live:
                self._leases[(name, tag)] = live
            else:
                del self._leases[(name, tag)]
            return sorted(live)

    def leased(self, name: str, tag: str) -> bool:
        return bool(self.lease_holders(name, tag))

    # ---------------------------------------------------------------- blobs
    def _blob_path(self, h: str) -> str:
        d = os.path.join(self.root, "blobs", "sha256", h[:2])
        return os.path.join(d, h)

    def has_blob(self, h: str) -> bool:
        return os.path.exists(self._blob_path(h))

    def write_blob(self, h: str, data) -> bool:
        """Returns True if a new blob was written (False = dedup hit)."""
        data = fault_point("store.write_blob", f"{self.root}:{h}", data)
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
            data = f.read()
        return fault_point("store.read_blob", f"{self.root}:{h}", data)

    def ensure_blob_durable(self, h: str) -> None:
        """Schedule durability for a blob ADOPTED from disk (an orphan of
        a crashed push that re-hashed intact). Existence does not prove
        the bytes ever hit stable storage — the crashed writer may have
        died before its deferred fsync — so an adopter must re-arm the
        fsync: inline under durability="full", at the next commit point
        under "batch". Idempotent and free for already-durable paths."""
        path = self._blob_path(h)
        if path in self._durable_paths:
            return
        if self.durability == "full":
            _fsync_path(path)
            _fsync_path(os.path.dirname(path))
            self.fsyncs += 2
            self._durable_paths.add(path)
        else:
            with self._dirty_lock:
                self._dirty_files.add(path)
                self._dirty_dirs.add(os.path.dirname(path))

    def drop_blob(self, h: str) -> bool:
        """Delete one blob (caller must know it is unreferenced — e.g. a
        torn orphan of a crashed push, detected by content-address
        mismatch). Returns False if it didn't exist."""
        path = self._blob_path(h)
        try:
            os.remove(path)
        except OSError:
            return False
        self._durable_paths.discard(path)
        with self._dirty_lock:
            self._dirty_files.discard(path)
        return True

    # ----------------------------------------------------------- quarantine
    def _quarantine_path(self, h: str) -> str:
        return os.path.join(self.root, "quarantine", h)

    def quarantine_blob(self, h: str) -> bool:
        """Move a corrupt blob out of the content-addressed namespace into
        ``<root>/quarantine/<h>`` (atomic rename — the bad bytes are
        preserved for forensics, the address is freed for a verified
        replacement). Unlike ``drop_blob`` this is safe on a blob that IS
        still referenced by committed manifests: the image goes from
        silently-corrupt to visibly-incomplete, which every reader already
        handles (``missing blob`` from ``verify_image``, ``OSError`` from
        ``read_blob``) and ``repair_image`` heals. Returns False if the
        blob didn't exist."""
        src = self._blob_path(h)
        dst = self._quarantine_path(h)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.replace(src, dst)
        except OSError:
            return False
        self._durable_paths.discard(src)
        with self._dirty_lock:
            self._dirty_files.discard(src)
        return True

    def quarantined_blobs(self) -> List[str]:
        """Content addresses currently held in quarantine."""
        d = os.path.join(self.root, "quarantine")
        if not os.path.isdir(d):
            return []
        return sorted(fn for fn in os.listdir(d) if _HEX_ID.fullmatch(fn))

    def purge_quarantine(self, h: Optional[str] = None) -> int:
        """Discard one quarantined blob (or all of them) for good — the
        operator's explicit override once the bad bytes are no longer
        interesting. Returns the number removed."""
        victims = [h] if h is not None else self.quarantined_blobs()
        n = 0
        for v in victims:
            try:
                os.remove(self._quarantine_path(v))
                n += 1
            except OSError:
                continue
        return n

    # ------------------------------------------------------ repair pinning
    def protect_paths(self, paths) -> None:
        """Pin absolute paths against the ``gc()`` sweep for the duration
        of a repair (see ``_protected_paths``). Idempotent."""
        with self._dirty_lock:
            self._protected_paths.update(paths)

    def unprotect_paths(self, paths) -> None:
        with self._dirty_lock:
            self._protected_paths.difference_update(paths)


    # --------------------------------------------------------------- layers
    def _layer_path(self, layer_id: str) -> str:
        return os.path.join(self.root, "layers", f"{layer_id}.json")

    def _cache_layer(self, layer: LayerDescriptor) -> None:
        if len(self._layer_cache) >= self._layer_cache_cap:
            self._layer_cache.pop(next(iter(self._layer_cache)))
        self._layer_cache[layer.layer_id] = layer

    def write_layer(self, layer: LayerDescriptor,
                    encoded: Optional[bytes] = None) -> None:
        """``encoded`` lets callers that already serialized the descriptor
        (e.g. the registry receive path, which counts its wire bytes) skip
        a second JSON encode — it must be ``dumps(layer.to_json())``."""
        self._write_file(self._layer_path(layer.layer_id),
                         encoded if encoded is not None
                         else dumps(layer.to_json()).encode())
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
        # a crash HERE is the classic torn-commit point: blobs/layers on
        # disk, manifest absent — the previous tag must stay authoritative
        fault_point("store.commit", self.root)
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
        self._holdings_apply_commit(manifest)

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

    def list_images(self) -> List[str]:
        """Every image name with a directory under ``images/``: the
        namespace ``gc()`` walks."""
        d = os.path.join(self.root, "images")
        return sorted(n for n in os.listdir(d)
                      if os.path.isdir(os.path.join(d, n)))

    def holdings_index(self, tag_window: int = 8,
                       fresh: bool = False) -> HoldingsIndex:
        """Index this store's committed holdings across EVERY image (see
        ``HoldingsIndex``) — what ``DeltaReceiver.negotiate``/``commit``
        vouch from, so a blob committed under ``base`` answers the probe
        for a push of ``tenant3``.

        ``committed_layers`` covers every tag of every image — an id
        referenced only by an old tag of a sibling image must still be
        protected from in-place overwrite. Only the descriptor-READING
        work (the family/re-key index and ``known_chunks``) is bounded to
        the ``tag_window`` newest tags *per image*: missing a match there
        only costs extra deep verification or a resent blob, never
        correctness. Cached per window; invalidated by this instance's own
        ``write_image``/``remove_image`` (``fresh=True`` bypasses — needed
        only when ANOTHER process commits into the same root)."""
        if not fresh:
            with self._holdings_lock:
                cached = self._holdings_cache.get(tag_window)
            if cached is not None:
                return cached
        idx, aux = HoldingsIndex(), _HoldingsAux()
        for name in self.list_images():
            tags = self.list_tags(name)
            if tags:        # a fully-untagged image holds nothing
                idx.images.append(name)
            stags = sorted(tags, reverse=True)
            if stags:
                aux.win_tags[name] = list(stags)
            for i, tag in enumerate(stags):
                try:
                    m, _ = self.read_image(name, tag)
                except (OSError, ValueError, KeyError):
                    continue
                for lid in m.layer_ids:
                    aux.layer_refs[lid] = aux.layer_refs.get(lid, 0) + 1
                idx.committed_layers.update(m.layer_ids)
                if i >= tag_window:
                    continue
                self._win_add_manifest(idx, aux, name, tag, m)
        with self._holdings_lock:
            self._holdings_cache[tag_window] = idx
            self._holdings_aux[tag_window] = aux
        return idx

    # -------------------------------------- incremental holdings maintenance
    def _win_add_manifest(self, idx: HoldingsIndex, aux: _HoldingsAux,
                          name: str, tag: str, m: Manifest) -> None:
        """Index a manifest's layers into the windowed (family / chunk)
        side of the holdings, recording exactly what was added so a later
        window eviction can subtract it. Shared by the full rebuild and
        the incremental write_image path — equivalence by construction."""
        added: List[str] = []
        for lid in m.layer_ids:
            if not self.has_layer(lid):
                continue
            layer = self.read_layer(lid)
            added.append(lid)
            n = aux.win_layer_refs.get(lid, 0)
            aux.win_layer_refs[lid] = n + 1
            if n:
                continue
            key = (layer.family, layer.checksum)
            members = aux.family_members.setdefault(key, set())
            members.add(lid)
            idx.by_family[key] = min(members)
            for rec in layer.records:
                for h in rec.chunks:
                    c = aux.chunk_refs.get(h, 0)
                    aux.chunk_refs[h] = c + 1
                    if not c:
                        idx.known_chunks.add(h)
        aux.win_added[(name, tag)] = added

    def _win_sub_tag(self, idx: HoldingsIndex, aux: _HoldingsAux,
                     name: str, tag: str) -> None:
        """Subtract a tag evicted from the window: exactly the layers
        ``_win_add_manifest`` recorded for it, refcounted down."""
        for lid in aux.win_added.pop((name, tag), []):
            n = aux.win_layer_refs.get(lid, 0) - 1
            if n < 0:
                raise _HoldingsStale
            if n:
                aux.win_layer_refs[lid] = n
                continue
            del aux.win_layer_refs[lid]
            layer = self.read_layer(lid)    # unreadable -> stale -> rebuild
            key = (layer.family, layer.checksum)
            members = aux.family_members.get(key, set())
            members.discard(lid)
            if members:
                idx.by_family[key] = min(members)
            else:
                aux.family_members.pop(key, None)
                idx.by_family.pop(key, None)
            for rec in layer.records:
                for h in rec.chunks:
                    c = aux.chunk_refs.get(h, 0) - 1
                    if c < 0:
                        raise _HoldingsStale
                    if c:
                        aux.chunk_refs[h] = c
                    else:
                        del aux.chunk_refs[h]
                        idx.known_chunks.discard(h)

    def _holdings_apply_commit(self, manifest: Manifest) -> None:
        """write_image hook: fold the committed manifest into every cached
        window instead of invalidating wholesale (the ROADMAP incremental-
        maintenance item). Unsound cases degrade to invalidation."""
        name, tag = manifest.name, manifest.tag
        with self._holdings_lock:
            for window in list(self._holdings_cache):
                idx = self._holdings_cache[window]
                aux = self._holdings_aux.get(window)
                try:
                    if aux is None:
                        raise _HoldingsStale
                    tags = aux.win_tags.setdefault(name, [])
                    if tag in tags:     # tag overwrite: old layer set gone
                        raise _HoldingsStale
                    for lid in manifest.layer_ids:
                        aux.layer_refs[lid] = \
                            aux.layer_refs.get(lid, 0) + 1
                    idx.committed_layers.update(manifest.layer_ids)
                    if name not in idx.images:
                        idx.images.append(name)
                        idx.images.sort()
                    old_win = tags[:window]
                    tags.append(tag)
                    tags.sort(reverse=True)
                    new_win = tags[:window]
                    for t in old_win:               # at most one eviction
                        if t not in new_win:
                            self._win_sub_tag(idx, aux, name, t)
                    if tag in new_win:
                        self._win_add_manifest(idx, aux, name, tag,
                                               manifest)
                except (_HoldingsStale, OSError, ValueError, KeyError):
                    self._holdings_cache.pop(window, None)
                    self._holdings_aux.pop(window, None)

    def _holdings_apply_remove(self, name: str, tag: str,
                               manifest: Optional[Manifest]) -> None:
        """remove_image hook: subtract the removed tag's layer set from
        every cached window (manifest was read before the unlink; None
        means it was unreadable — invalidate)."""
        with self._holdings_lock:
            for window in list(self._holdings_cache):
                idx = self._holdings_cache[window]
                aux = self._holdings_aux.get(window)
                try:
                    if aux is None or manifest is None:
                        raise _HoldingsStale
                    tags = aux.win_tags.get(name, [])
                    if tag not in tags:
                        raise _HoldingsStale
                    old_win = tags[:window]
                    tags.remove(tag)
                    new_win = tags[:window]
                    for lid in manifest.layer_ids:
                        n = aux.layer_refs.get(lid, 0) - 1
                        if n < 0:
                            raise _HoldingsStale
                        if n:
                            aux.layer_refs[lid] = n
                        else:
                            aux.layer_refs.pop(lid, None)
                            idx.committed_layers.discard(lid)
                    if tag in old_win:
                        self._win_sub_tag(idx, aux, name, tag)
                    for t in new_win:               # at most one promotion
                        if t not in old_win:
                            m2, _ = self.read_image(name, t)
                            self._win_add_manifest(idx, aux, name, t, m2)
                    if not tags:
                        aux.win_tags.pop(name, None)
                        if name in idx.images:
                            idx.images.remove(name)
                except (_HoldingsStale, OSError, ValueError, KeyError):
                    self._holdings_cache.pop(window, None)
                    self._holdings_aux.pop(window, None)

    def remove_image(self, name: str, tag: str, force: bool = False) -> bool:
        """Unlink a tag's manifest (layers/blobs become GC fodder; run
        ``gc()`` to reclaim them). Returns False if the tag didn't exist —
        or if an unexpired retention lease holds it (a relay's lagging
        child still needs its blobs; ``force=True`` overrides, for callers
        that know the children are gone for good)."""
        if not force and self.leased(name, tag):
            return False
        try:                # read BEFORE unlink: the incremental holdings
            manifest, _ = self.read_image(name, tag)   # subtraction needs
        except (OSError, ValueError, KeyError):        # the layer set
            manifest = None
        try:
            os.remove(os.path.join(self.root, "images", name, f"{tag}.json"))
        except OSError:
            return False
        self._tags_cache.pop(name, None)
        self._holdings_apply_remove(name, tag, manifest)
        return True

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
    def load_layer_payload(self, layer: LayerDescriptor
                           ) -> Dict[str, torch.Tensor]:
        """A layer's tensors assembled from their chunk blobs, as host
        tensors (bf16 records come back as ``torch.bfloat16``)."""
        return {r.name: assemble_tensor(r, self.read_blob)
                for r in layer.records}

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

    # ------------------------------------------------------------------- GC
    def add_gc_hook(self, hook) -> None:
        """Register ``hook(store) -> {stat: count}`` to run at the end of
        every ``gc()`` — retention awareness for satellites that
        advertise committed tags (``PassiveRegistry.attach_gc`` prunes
        published bundles whose endpoint tags were swept). A hook that
        raises is skipped, never fails the sweep."""
        self._gc_hooks.append(hook)

    def gc(self) -> Dict[str, int]:
        """Mark-and-sweep of unreferenced blobs, layer descriptors and
        config blobs across the whole image namespace: the roots are every
        committed tag of every image, so a blob that another image still
        reaches survives. The sweep spares the files of an open batch
        transaction (written, not yet flushed at a commit): an in-flight
        save's blobs are never deleted out from under its manifest, and
        neither are the paths an in-progress repair pinned
        (``protect_paths``). Retention leases pin transitively: a leased
        tag's manifest cannot be removed, so it stays a root. Registered
        hooks (``add_gc_hook``) run last. Must not run beside a
        ``durability="full"`` writer, whose pre-commit files are not
        tracked."""
        marked_blobs: set = set()
        marked_layers: set = set()
        marked_configs: set = set()
        for name in self.list_images():
            for tag in self.list_tags(name):
                try:
                    manifest, config = self.read_image(name, tag)
                except (OSError, ValueError, KeyError):
                    continue
                marked_configs.add(config.config_id)
                for lid in manifest.layer_ids:
                    marked_layers.add(lid)
                    if not self.has_layer(lid):
                        continue
                    try:
                        layer = self.read_layer(lid)
                    except (OSError, ValueError, KeyError):
                        continue
                    for rec in layer.records:
                        marked_blobs.update(rec.chunks)

        with self._dirty_lock:
            # exemptions: the open batch transaction's dirty files AND any
            # path pinned by an in-progress RepairSession (protect_paths)
            protected = set(self._dirty_files) | set(self._protected_paths)
        stats = {"layers_swept": 0, "blobs_swept": 0, "bytes_swept": 0,
                 "configs_swept": 0}

        layers_dir = os.path.join(self.root, "layers")
        for fn in os.listdir(layers_dir):
            lid = fn[:-5]
            if not fn.endswith(".json") or not _HEX_ID.fullmatch(lid) or \
                    lid in marked_layers:
                continue
            path = os.path.join(layers_dir, fn)
            if path in protected:
                continue
            try:
                os.remove(path)
            except OSError:
                continue
            self._layer_cache.pop(lid, None)
            self._durable_paths.discard(path)
            stats["layers_swept"] += 1

        blob_root = os.path.join(self.root, "blobs", "sha256")
        for sub in os.listdir(blob_root):
            d = os.path.join(blob_root, sub)
            if not os.path.isdir(d):
                continue
            for fn in os.listdir(d):
                if len(fn) != 64 or not _HEX_ID.fullmatch(fn) or \
                        fn in marked_blobs:
                    continue
                path = os.path.join(d, fn)
                if path in protected:
                    continue
                try:
                    size = os.path.getsize(path)
                    os.remove(path)
                except OSError:
                    continue
                self._durable_paths.discard(path)
                stats["blobs_swept"] += 1
                stats["bytes_swept"] += size

        for name in self.list_images():
            d = os.path.join(self.root, "images", name)
            for fn in os.listdir(d):
                stem = fn[:-5]
                if not fn.endswith(".json") or not _HEX_ID.fullmatch(stem) \
                        or stem in marked_configs:
                    continue
                path = os.path.join(d, fn)
                if path in protected:
                    continue
                try:
                    os.remove(path)
                except OSError:
                    continue
                stats["configs_swept"] += 1
        for hook in list(self._gc_hooks):
            try:
                extra = hook(self) or {}
            except CrashInjected:
                raise           # a simulated SIGKILL inside a hook is the
                # sweeping process dying, not "a broken hook"
            except Exception:  # noqa: BLE001
                continue        # a broken hook must never break the sweep
            for k, v in extra.items():
                stats[k] = stats.get(k, 0) + int(v)
        return stats

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

    # ---------------------------------------------------------------- scrub
    def scrub(self, max_bytes: Optional[int] = None,
              max_items: Optional[int] = None,
              reset: bool = False) -> "ScrubReport":
        """Integrity walk over the WHOLE store — the detection half of the
        self-healing loop (``ft/scrub.py`` owns the result model,
        ``repair_image`` in core/registry.py consumes the findings).

        Two phases per pass:

        1. **metadata** (first slice of a pass only): every committed
           tag's manifest, config locks, layer content checksums and chain
           re-key links are re-verified from the bytes on disk (never the
           cache), and committed chunks are checked for existence —
           exactly ``verify_image(deep=False)``'s checks plus missing-blob
           detection, across the full namespace.
        2. **blobs**: every payload under ``blobs/sha256`` is re-hashed
           against its content address, shard by shard (256 shards). A
           mismatch on a committed blob is a ``corrupt_blob`` finding
           attributed to the first (image, tag, layer) that references
           it; unreferenced blobs are ``orphan_blob`` debris.

        ``max_bytes``/``max_items`` bound one slice's re-hash work (at
        shard granularity; at least one shard always makes progress) —
        when the budget runs out the position persists in
        ``<root>/scrub.cursor.json`` and the next call resumes there, so a
        fleet-scale store is scrubbed across many short slices. The
        attribution map is rebuilt each slice (cheap metadata reads); the
        byte-heavy re-hashing never repeats a shard within a pass.
        ``reset=True`` discards the cursor and starts a fresh pass.

        Paths belonging to the open batch transaction or pinned by an
        in-progress repair are skipped — they are not committed state.
        Losing the cursor (crash between slices) only costs re-scrubbed
        shards, never a false verdict.
        """
        t0 = time.perf_counter()
        rep = ScrubReport()
        if reset:
            clear_cursor(self.root)
        cursor = load_cursor(self.root)
        first_slice = cursor == 0
        with self._dirty_lock:
            in_flight = set(self._dirty_files) | set(self._protected_paths)

        # metadata walk: attribution map (every slice) + integrity
        # findings (first slice of the pass only — they would duplicate)
        refs: Dict[str, Tuple[str, str, str]] = {}
        committed_lids: set = set()
        flagged: set = set()            # (kind, id) dedup across shared refs
        for name in self.list_images():
            seen = False
            for tag in self.list_tags(name, fresh=True):
                try:
                    manifest, config = self.read_image(name, tag)
                except (OSError, ValueError, KeyError) as e:
                    if first_slice:
                        rep.findings.append(ScrubFinding(
                            "manifest_unreadable", detail=str(e),
                            image=name, tag=tag))
                    continue
                seen = True
                parent_chain: Optional[str] = None
                chain_broken = False
                for lid in manifest.layer_ids:
                    committed_lids.add(lid)
                    if not self.has_layer(lid):
                        if first_slice and ("missing_layer", lid) not in flagged:
                            flagged.add(("missing_layer", lid))
                            rep.findings.append(ScrubFinding(
                                "missing_layer", image=name, tag=tag,
                                layer_id=lid))
                        chain_broken = True
                        continue
                    try:
                        layer = self.read_layer(lid, use_cache=False)
                    except (OSError, ValueError, KeyError) as e:
                        if first_slice and ("layer_unreadable", lid) not in flagged:
                            flagged.add(("layer_unreadable", lid))
                            rep.findings.append(ScrubFinding(
                                "layer_unreadable", detail=str(e),
                                image=name, tag=tag, layer_id=lid))
                        chain_broken = True
                        continue
                    rep.layers_scanned += 1
                    if first_slice:
                        if content_checksum(layer.records) != layer.checksum \
                                and ("layer_checksum_mismatch", lid) not in flagged:
                            flagged.add(("layer_checksum_mismatch", lid))
                            rep.findings.append(ScrubFinding(
                                "layer_checksum_mismatch", image=name,
                                tag=tag, layer_id=lid))
                        if config.layer_checksums.get(lid) != layer.checksum \
                                and ("config_lock_mismatch", lid) not in flagged:
                            flagged.add(("config_lock_mismatch", lid))
                            rep.findings.append(ScrubFinding(
                                "config_lock_mismatch", image=name,
                                tag=tag, layer_id=lid))
                        if not chain_broken:
                            expected = chain_checksum(
                                parent_chain, layer.checksum,
                                layer.instruction.text)
                            if (expected != layer.chain or
                                    config.layer_chains.get(lid) != layer.chain) \
                                    and ("chain_mismatch", lid) not in flagged:
                                flagged.add(("chain_mismatch", lid))
                                rep.findings.append(ScrubFinding(
                                    "chain_mismatch", image=name, tag=tag,
                                    layer_id=lid))
                    for rec in layer.records:
                        for h in rec.chunks:
                            refs.setdefault(h, (name, tag, lid))
                            if first_slice and not self.has_blob(h) \
                                    and ("missing_blob", h) not in flagged:
                                flagged.add(("missing_blob", h))
                                rep.findings.append(ScrubFinding(
                                    "missing_blob", image=name, tag=tag,
                                    layer_id=lid, blob=h))
                    parent_chain = layer.chain
            if seen:
                rep.images_scanned += 1

        if first_slice:
            layers_dir = os.path.join(self.root, "layers")
            for fn in sorted(os.listdir(layers_dir)):
                lid = fn[:-5]
                if not fn.endswith(".json") or not _HEX_ID.fullmatch(lid) \
                        or lid in committed_lids:
                    continue
                if os.path.join(layers_dir, fn) in in_flight:
                    continue
                rep.findings.append(ScrubFinding(
                    "orphan_layer", detail="descriptor unreachable from "
                    "any committed tag", layer_id=lid))

        # blob phase: re-hash shards from the cursor until done or budget
        blob_root = os.path.join(self.root, "blobs", "sha256")
        shard = cursor
        budget_hit = False
        while shard < N_SHARDS:
            d = os.path.join(blob_root, f"{shard:02x}")
            if os.path.isdir(d):
                for fn in sorted(os.listdir(d)):
                    if len(fn) != 64 or not _HEX_ID.fullmatch(fn):
                        continue
                    path = os.path.join(d, fn)
                    if path in in_flight:
                        continue
                    try:
                        with open(path, "rb") as f:
                            data = f.read()
                    except OSError:
                        continue
                    rep.blobs_scanned += 1
                    rep.bytes_scanned += len(data)
                    if sha256_hex(data) != fn:
                        where = refs.get(fn)
                        if where:
                            rep.findings.append(ScrubFinding(
                                "corrupt_blob",
                                detail="content re-hash mismatch",
                                image=where[0], tag=where[1],
                                layer_id=where[2], blob=fn))
                        else:
                            rep.findings.append(ScrubFinding(
                                "orphan_blob",
                                detail="unreferenced, fails re-hash",
                                blob=fn))
                    elif fn not in refs:
                        rep.findings.append(ScrubFinding(
                            "orphan_blob", detail="unreferenced", blob=fn))
            rep.shards_scanned += 1
            shard += 1
            if shard < N_SHARDS and (
                    (max_bytes is not None and rep.bytes_scanned >= max_bytes)
                    or (max_items is not None
                        and rep.blobs_scanned >= max_items)):
                budget_hit = True
                break

        if budget_hit:
            rep.next_shard = shard
            save_cursor(self.root, shard)
        else:
            rep.complete = True
            rep.next_shard = 0
            clear_cursor(self.root)
        rep.wall_s = time.perf_counter() - t0
        return rep

    # ------------------------------------------- explicit decompose (export)
    def export_image(self, name: str, tag: str) -> bytes:
        """`docker save`-style bundled tar (manifest + config + layer tars).

        The *explicit* decomposition path of paper §III.A: everything is
        serialized through an intermediate archive.
        """
        manifest, config = self.read_image(name, tag)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            def add(name_: str, data: bytes) -> None:
                info = tarfile.TarInfo(name_)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))

            add("manifest.json", dumps(manifest.to_json()).encode())
            add(f"{config.config_id}.json", dumps(config.to_json()).encode())
            for lid in manifest.layer_ids:
                layer = self.read_layer(lid)
                add(f"{lid}/json", dumps(layer.to_json()).encode())
                add(f"{lid}/VERSION", str(layer.version).encode())
                inner = io.BytesIO()
                with tarfile.open(fileobj=inner, mode="w") as ltar:
                    for rec in layer.records:
                        data = b"".join(self.read_blob(h) for h in rec.chunks)
                        info = tarfile.TarInfo(rec.name)
                        info.size = len(data)
                        ltar.addfile(info, io.BytesIO(data))
                add(f"{lid}/layer.tar", inner.getvalue())
        return buf.getvalue()

    def import_image(self, bundle: bytes) -> Tuple[str, str]:
        """`docker load` counterpart."""
        with tarfile.open(fileobj=io.BytesIO(bundle), mode="r") as tar:
            manifest = Manifest.from_json(
                json.loads(tar.extractfile("manifest.json").read()))
            config = ImageConfig.from_json(
                json.loads(tar.extractfile(f"{manifest.config_id}.json").read()))
            for lid in manifest.layer_ids:
                layer = LayerDescriptor.from_json(
                    json.loads(tar.extractfile(f"{lid}/json").read()))
                inner = tarfile.open(
                    fileobj=io.BytesIO(tar.extractfile(f"{lid}/layer.tar").read()))
                for rec in layer.records:
                    data = inner.extractfile(rec.name).read()
                    off = 0
                    for h in rec.chunks:
                        piece = data[off:off + rec.chunk_bytes]
                        off += len(piece)
                        self.write_blob(h, piece)
                self.write_layer(layer)
        self.write_image(manifest, config)
        return manifest.name, manifest.tag

    # -------------------------------------------- implicit decompose (inplace)
    def open_layer_inplace(self, layer_id: str) -> LayerDescriptor:
        """Paper §III.A *implicit* decomposition: read the layer descriptor
        straight out of the store ("/var/lib/docker/overlay2/<id>/") without
        any intermediate archive. Chunk blobs are then addressable directly.
        """
        return self.read_layer(layer_id)
