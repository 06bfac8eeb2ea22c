"""Remote-registry model — paper §III.C (redeployment) (torch port of
``repro/core/registry.py``). The registry moves bytes and metadata only:
no tensor is rebuilt here, so the wire, the bundles and the stats are the
reference's, and either package's store can be the other's peer.

A "remote" is another LayerStore behind a ``DeltaReceiver`` — the endpoint
of the wire protocol, which *verifies everything it receives*. Two push
paths share the same integrity gate (a naive in-place mutation — same layer
id, diverged checksum — is REJECTED; a clone-before-inject with a new id
and re-keyed manifest is ACCEPTED):

* ``push`` — the seed O(image) baseline: walk every layer, send missing
  blobs one at a time, then ``verify_image(deep=True)`` at the destination
  (a full re-hash of the whole image on every push).

* ``push_delta`` — the O(changed-bytes) path. The have-set is negotiated
  in **batched set-difference exchanges** (``DeltaReceiver.negotiate``:
  every has_layer probe in one O(#layers) request; ``probe_blobs``: every
  has_blob probe in one request covering only new-content layers' chunks),
  telling the source exactly what the remote is missing *and* which missing
  layers are content-identical re-keyed clones of layers the remote already
  verified (matched by family + content checksum — the re-key table). Only
  genuinely new chunk blobs cross the wire, on a **pipelined transfer**: blob read -> send ->
  content-address verify -> write run concurrently per blob on the shared
  hash pool, with the receiving store under ``durability="batch"`` so every
  per-blob fsync coalesces into one concurrent flush at the remote
  manifest commit. Verification is **incremental**: received blobs are
  hashed exactly once (on receipt, overlapped with the transfer), re-keyed
  clones are checked by checksum equality against the layer the remote
  already holds, and only layers with genuinely new content get the deep
  membership check — the remote never re-hashes bytes it verified on an
  earlier push. ``PushStats.layers_deep_verified`` proves the "deep-verify
  only new layers" claim; CI gates it.

* ``replicate_fanout`` — the fleet form of ``push_delta``: one training
  source feeding N serving replicas. The have-set is negotiated in ONE
  round (every replica answers the same O(#layers) request; the answers
  are unioned into a single plan), each changed blob is read from the
  source store exactly once and broadcast to every replica missing it,
  and failures are isolated per replica (``ReplicaResult``) so a sick or
  slow destination never blocks the healthy ones — a clean retry
  converges it. ``push_delta`` itself is the N=1 special case.

* ``RelayNode`` — the multi-hop form: one store that is a
  ``DeltaReceiver`` toward its parent and a fan-out source toward its
  children (trainer -> M relays -> N edge followers each). The parent's
  delta header seeds the child have-set union, so a blob received once at
  the relay is forwarded straight from the wire buffer (``inflight``) or
  read locally exactly once (``commit`` mode / stale children) — never
  re-read or re-hashed per child — and a child only ever commits after
  its relay committed.

The trust boundary is **cross-image** (one content-addressed blob
universe per store): "held" means reachable from a committed manifest of
ANY image, so negotiation, the re-key table, blob probes and commit-time
vouching all answer from the whole namespace — pushing a fine-tune to a
replica that only holds the base image transfers just the adapter deltas
(see ``LayerStore.holdings_index``; docs/ARCHITECTURE.md spells out the
held/committed/vouched model). The mutation gate and orphan
re-verification keep their exact semantics across images: a committed id
is immutable no matter which image committed it, and an uncommitted
on-disk blob/descriptor is never vouched for by a sibling image — only a
re-hash can adopt it.

``export_delta``/``import_delta`` are the offline (``docker save``-style)
form of the same protocol: a self-checking ``DeltaBundle`` byte string
computed against a base tag instead of a live have-set (``import_delta``
at a ``RelayNode`` re-fans the bundle to an edge tier).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..ft.faults import CrashInjected, fault_point
from ..ft.retry import RetryHealth, RetryPolicy
from .chunker import hash_pool, sha256_hex
from .delta import (BundleEntry, BundleIndex, DeltaBundle, DeltaFormatError,
                    compose_delta_records, decode_delta, decode_index,
                    encode_delta, encode_index)
from .diff import diff_manifests
from .manifest import (ImageConfig, LayerDescriptor, Manifest, chain_checksum,
                       content_checksum, dumps, history_delta_chain, new_uuid)
from .store import LayerStore


class PushRejected(RuntimeError):
    pass


@dataclass
class PushStats:
    blobs_sent: int = 0
    blobs_dedup: int = 0
    layers_sent: int = 0
    layers_dedup: int = 0
    # bytes_sent is EVERYTHING on the wire: blob payloads + layer
    # descriptors + manifest/config (+ the negotiation exchange for the
    # delta path) — true wire amplification, not just payload.
    bytes_sent: int = 0
    bytes_payload: int = 0       # blob payload bytes only
    bytes_meta: int = 0          # descriptor + manifest/config (+ have-set)
    bytes_deduped: int = 0       # payload bytes NOT resent thanks to dedup
    wall_s: float = 0.0
    # Incremental-verification accounting (delta path; seed push re-hashes
    # the whole image so its deep count is every layer).
    layers_deep_verified: int = 0
    layers_rekey_verified: int = 0
    blobs_hashed_remote: int = 0


def push(src: LayerStore, dst: LayerStore, name: str, tag: str) -> PushStats:
    """Seed baseline: O(image) walk + full deep re-verification at dst."""
    stats = PushStats()
    t0 = time.perf_counter()
    problems = src.verify_image(name, tag, deep=False)
    if problems:
        raise PushRejected(f"source image fails verification: {problems}")
    manifest, config = src.read_image(name, tag)

    total_payload = 0
    for lid in manifest.layer_ids:
        layer = src.read_layer(lid)
        total_payload += layer.nbytes
        if dst.has_layer(lid):
            existing = dst.read_layer(lid)
            if existing.checksum != layer.checksum:
                # The paper's exact failure mode: same id, diverged content.
                raise PushRejected(
                    f"layer {lid}: remote holds a different checksum trace "
                    "for this id (in-place mutation without a new id?)")
            stats.layers_dedup += 1
        else:
            stats.layers_sent += 1
        for rec in layer.records:
            for h in rec.chunks:
                if dst.has_blob(h):
                    stats.blobs_dedup += 1
                else:
                    data = src.read_blob(h)
                    dst.write_blob(h, data)
                    stats.blobs_sent += 1
                    stats.bytes_payload += len(data)
        # the seed path resends EVERY descriptor, dedup'd or not
        data = dumps(layer.to_json()).encode()
        stats.bytes_meta += len(data)
        dst.write_layer(layer, encoded=data)
    stats.bytes_meta += len(dumps(manifest.to_json()).encode())
    stats.bytes_meta += len(dumps(config.to_json()).encode())
    dst.write_image(manifest, config)

    problems = dst.verify_image(name, tag, deep=True)
    stats.layers_deep_verified = len(manifest.layer_ids)
    if problems:
        raise PushRejected(f"post-push verification failed: {problems}")
    stats.bytes_sent = stats.bytes_payload + stats.bytes_meta
    stats.bytes_deduped = total_payload - stats.bytes_payload
    stats.wall_s = time.perf_counter() - t0
    return stats


def pull(src: LayerStore, dst: LayerStore, name: str, tag: str) -> PushStats:
    return push(src, dst, name, tag)


# --------------------------------------------------------------------------
# Delta protocol
# --------------------------------------------------------------------------

@dataclass
class HaveSet:
    """The remote's answer to ONE negotiation request: what it is missing,
    plus the re-key table for missing layers it can prove content-identical
    to layers it already holds."""

    missing_layers: List[str] = field(default_factory=list)
    missing_blobs: Set[str] = field(default_factory=set)
    held_checksums: Dict[str, str] = field(default_factory=dict)
    rekey: Dict[str, str] = field(default_factory=dict)
    exchange_bytes: int = 0      # request+response size (counted as meta)


def _stamp_dedup(stats: PushStats, total_refs: int, total_payload: int,
                 t0: float) -> None:
    """Post-commit dedup accounting from record metadata (no per-blob
    stats): everything the image references that did NOT cross the wire.
    Shared by every fan-out tier so the books can't drift apart."""
    stats.blobs_dedup = total_refs - stats.blobs_sent
    stats.bytes_deduped = total_payload - stats.bytes_payload
    stats.wall_s = time.perf_counter() - t0


def _gate_mutations(layer_meta: Dict[str, Tuple[str, str]],
                    held_checksums: Dict[str, str], who: str) -> None:
    """The in-place-mutation gate, shared by every tier: a destination
    holding one of the image's layer ids with a DIVERGED checksum is the
    paper's exact failure mode — rejected before any byte moves."""
    for lid, held in held_checksums.items():
        if layer_meta[lid][1] != held:
            raise PushRejected(
                f"layer {lid}: {who} holds a different checksum trace "
                "for this id (in-place mutation without a new id?)")


class _BatchScope:
    """Hold the receiving store in durability="batch" for the lifetime of a
    push so per-blob fsyncs coalesce at the remote manifest commit."""

    def __init__(self, store: LayerStore):
        self.store = store
        self._prev: Optional[str] = None

    def __enter__(self):
        self._prev = self.store.durability
        self.store.durability = "batch"
        return self

    def __exit__(self, exc_type, exc, tb):
        # write_image (the commit) already flushed deferred fsyncs, so this
        # is a no-op after a committed push. After a FAILED one (exception
        # here, or a per-replica failure captured by the fan-out) the
        # push's blobs are on disk but un-fsynced — and a later push's
        # ``probe_blobs`` orphan re-hash would ADOPT them as verified
        # without ever scheduling the fsync it skipped. Flush them before
        # leaving the scope: a crash-mid-batch must never leave bytes that
        # look adoptable but were never made durable.
        self.store.sync_for_commit()
        self.store.durability = self._prev
        return False


class DeltaReceiver:
    """The remote endpoint of a delta push.

    Wire ops: ``negotiate`` (one set-difference exchange), ``receive_layer``
    / ``receive_blob`` (streamed; blobs are content-address-verified on
    receipt — the only time new bytes are ever hashed), and ``commit``
    (incremental verification + the manifest rename). A crash anywhere
    before ``commit`` leaves the remote's previous tag fully intact: blobs
    and descriptors are orphans until the manifest rename, exactly the
    store's normal crash model.
    """

    # Tags scanned (newest first, per image) when indexing the remote's
    # holdings: the re-key/family matches worth finding live in the most
    # recent tags; scanning fewer tags only costs extra deep verification,
    # never correctness — and keeps negotiate O(images x window), not
    # O(push history).
    TAG_WINDOW = 8

    def __init__(self, store: LayerStore):
        self.store = store
        self._stats_lock = threading.Lock()   # receive_blob runs on a pool
        self.begin_push()

    def begin_push(self) -> None:
        """Reset per-push state. ``push_delta``/``replicate_fanout`` build
        fresh receivers for plain stores, but a long-lived receiver (a
        ``RelayNode`` reused across polls/retries, a receiver handed to
        ``import_delta`` twice) must be re-armed here at the START of each
        push so one push's verified-blob set or stats never vouch for the
        next. Deliberately NOT called from ``negotiate``: the
        ``negotiations`` counter must keep counting across a whole push so
        ``FanoutStats.negotiation_rounds`` measures extra rounds instead
        of tautologically reading 1."""
        self.negotiations = 0        # negotiate() exchanges this push
        self._verified_blobs: Set[str] = set()
        self._received_layers: Dict[str, LayerDescriptor] = {}
        # chunk ids referenced by COMMITTED layers of this image (built by
        # _scan_committed, pure metadata): membership here means present
        # AND verified by an earlier successful push — no stat, no hash
        self._known_chunks: Set[str] = set()
        # layer ids reachable from a committed manifest. A descriptor file
        # that exists but is NOT in this set is an orphan of a crashed push
        # — possibly torn under batch durability — and must never be
        # trusted as "held".
        self._committed_layers: Optional[Set[str]] = None
        self.rekey: Dict[str, str] = {}
        self.stats = PushStats()

    def _scan_committed(self, name: str) -> Dict[Tuple[str, str], str]:
        """Index this store's committed holdings — across EVERY image, not
        just ``name`` (the cross-image blob universe): a blob or layer
        committed under ``base`` vouches for a push of ``tenant3``, which
        is what makes replicating a fine-tune to a replica that already
        holds the base image cost O(adapter), not O(image).

        ``_committed_layers`` (the held/mutation-gate set) covers EVERY
        committed tag of EVERY image — an id referenced only by an old tag
        of a sibling image must still be protected from overwrite. Only
        the descriptor-reading work — the family index for re-key matching
        and ``_known_chunks`` — is bounded to the TAG_WINDOW newest tags
        per image; missing a match there only costs extra deep
        verification, never correctness. The scan itself is served from
        the store's cached ``holdings_index`` (invalidated at its own
        commit/removal points), so repeated pushes don't re-walk the
        namespace. ``name`` is kept for wire-protocol shape (the request
        names the image being pushed) but no longer narrows the answer."""
        del name                     # the whole namespace answers now
        idx = self.store.holdings_index(tag_window=self.TAG_WINDOW)
        # copies: the index is a shared cache entry; per-push state must
        # never alias it (receive/commit mutate _known_chunks' siblings)
        self._committed_layers = set(idx.committed_layers)
        self._known_chunks.update(idx.known_chunks)
        return dict(idx.by_family)

    # ------------------------------------------------------------ negotiate
    def negotiate(self, name: str,
                  layer_meta: Dict[str, Tuple[str, str]]) -> HaveSet:
        """The layer set-difference exchange — every has_layer probe
        batched into one request. ``layer_meta`` maps layer_id ->
        (family, content_checksum) for the manifest's layers, in manifest
        order (O(#layers) metadata, never chunk lists). Returns missing
        layers, checksums of held layers (the in-place-mutation gate runs
        against these), and the re-key table: missing layers whose
        (family, checksum) matches a layer this store already holds under
        ANY committed tag of ANY image — a fine-tune's unchanged layers
        may be vouched for by the base image's holdings, so those need no
        blob probes and no deep verification: content-checksum equality
        over the chunk-hash list proves every blob is already present and
        verified, whatever image name committed it.

        "Held" means reachable from a COMMITTED manifest (of any image) —
        a descriptor orphaned by a crashed earlier push is reported
        missing, so it gets re-received and re-verified rather than
        trusted.

        Crash/retry contract: pure metadata — no store mutation, so a
        crash during (or after) negotiate leaves nothing to clean up and
        a retry simply renegotiates. Counters: increments
        ``negotiations`` (surfaced as ``FanoutStats.negotiation_rounds``,
        CI-gated to 1 per push) and accounts the request+response size in
        ``HaveSet.exchange_bytes`` (folded into ``PushStats.bytes_meta``).
        """
        have = HaveSet()
        fault_point("wire.negotiate", self.store.root)
        self.negotiations += 1
        by_family = self._scan_committed(name)

        for lid, (family, checksum) in layer_meta.items():
            if lid in self._committed_layers and self.store.has_layer(lid):
                have.held_checksums[lid] = self.store.read_layer(lid).checksum
                continue
            have.missing_layers.append(lid)
            twin = by_family.get((family, checksum))
            if twin is not None:
                have.rekey[lid] = twin
        # request = (lid, family, checksum) rows; response = the sets
        have.exchange_bytes = sum(
            len(lid) + len(fam) + len(cs)
            for lid, (fam, cs) in layer_meta.items())
        have.exchange_bytes += sum(
            len(lid) + len(cs) for lid, cs in have.held_checksums.items())
        have.exchange_bytes += sum(len(x) for x in have.missing_layers)
        have.exchange_bytes += sum(len(a) + len(b)
                                   for a, b in have.rekey.items())
        self.rekey = dict(have.rekey)
        return have

    def probe_blobs(self, chunk_ids: Sequence[str]) -> Set[str]:
        """The blob set-difference exchange — every has_blob probe batched
        into one request. Callers only probe chunks of genuinely-new-content
        layers (re-keyed clones were already settled by ``negotiate``), so
        this message is O(changed-layer chunks), not O(image chunks); and
        chunks already referenced by committed layers — of ANY image, the
        cross-image universe — are answered from metadata
        (``_known_chunks``) without touching the filesystem.

        A blob that exists on disk but is NOT committed-known under any
        image is an orphan of a crashed push — possibly torn (batch
        durability defers fsyncs). It is re-hashed here: intact orphans
        are adopted as verified (and their deferred fsync re-armed); torn
        ones are deleted (unreferenced, so safe) and reported missing so
        the pusher resends them. Adoption is strictly content-addressed —
        a sibling image being committed never vouches for an uncommitted
        blob; only the re-hash does. Either way a retry after a crash
        converges; the cost is O(orphaned chunks), zero on a clean store.

        Crash/retry contract: the only mutations are deleting torn
        orphans (unreferenced by construction) and re-arming fsyncs —
        both idempotent; a crash mid-probe loses nothing a retry can't
        redo. Counters: adopted orphans increment
        ``PushStats.blobs_hashed_remote``; probe traffic lands in
        ``bytes_meta``."""
        fault_point("wire.probe_blobs", self.store.root)
        missing: Set[str] = set()
        for h in chunk_ids:
            if h in self._known_chunks or h in self._verified_blobs:
                continue
            if not self.store.has_blob(h):
                missing.add(h)
                continue
            if sha256_hex(self.store.read_blob(h)) == h:
                self._verified_blobs.add(h)
                self.stats.blobs_hashed_remote += 1
                # adoption must re-arm the fsync the crashed writer never
                # issued — intact-on-read does not mean durable-on-disk
                self.store.ensure_blob_durable(h)
            else:
                self.store.drop_blob(h)      # torn orphan: resend
                missing.add(h)
        self.stats.bytes_meta += sum(len(h) for h in chunk_ids)
        self.stats.bytes_meta += sum(len(h) for h in missing)
        return missing

    # ------------------------------------------------------------- receive
    def receive_layer(self, layer: LayerDescriptor,
                      encoded: Optional[bytes] = None) -> int:
        """A committed descriptor is IMMUTABLE at this store — whichever
        image committed it: receiving the same id with a diverged checksum
        is the in-place mutation the gate exists for (this is what keeps
        the offline ``import_delta`` path as safe as the negotiated one,
        and what stops a tenant push from rewriting a base image's layer
        in place); an identical re-send is a no-op. ``encoded`` lets a
        fan-out source serialize each descriptor once for every replica
        (must be ``dumps(layer.to_json())``). A crash after the write
        leaves an orphan descriptor the next push re-verifies, never
        trusts; counters: ``PushStats.layers_sent`` / ``bytes_meta``."""
        fault_point("wire.receive_layer",
                    f"{self.store.root}:{layer.layer_id}")
        if self._committed_layers is not None and \
                layer.layer_id in self._committed_layers and \
                self.store.has_layer(layer.layer_id):
            held = self.store.read_layer(layer.layer_id)
            if held.checksum != layer.checksum:
                raise PushRejected(
                    f"layer {layer.layer_id}: already committed here with a "
                    "different checksum trace (in-place mutation without a "
                    "new id?)")
            return 0
        data = encoded if encoded is not None \
            else dumps(layer.to_json()).encode()
        self._received_layers[layer.layer_id] = layer
        self.store.write_layer(layer, encoded=data)
        self.stats.layers_sent += 1
        self.stats.bytes_meta += len(data)
        return len(data)

    def receive_blob(self, h: str, data: bytes) -> int:
        """Content-address verification happens HERE, overlapped with the
        transfer — the only time a pushed byte is ever hashed remotely.

        Crash/retry contract: a mismatching payload raises ``PushRejected``
        before the blob is linked in; a crash after the write leaves an
        orphan blob that the next push's ``probe_blobs`` re-hashes (adopt
        or drop+resend) — received bytes are never durable-trusted until
        the commit point flushes them. Thread-safe (fan-out receives run
        on the shared hash pool). Counters: ``PushStats.blobs_sent``,
        ``blobs_hashed_remote``, ``bytes_payload``."""
        data = fault_point("wire.receive_blob",
                           f"{self.store.root}:{h}", data)
        if sha256_hex(data) != h:
            raise PushRejected(f"blob {h[:12]}: payload does not match its "
                               "content address (corrupt transfer)")
        self.store.write_blob(h, data)
        with self._stats_lock:
            self._verified_blobs.add(h)
            self.stats.blobs_hashed_remote += 1
            self.stats.blobs_sent += 1
            self.stats.bytes_payload += len(data)
        return len(data)

    def _blob_ok(self, h: str) -> bool:
        """A chunk passes if it was verified on receipt this push, is
        referenced by a committed (earlier-verified) layer, or — the
        crashed-push orphan case — exists on disk AND re-hashes to its
        address (adopted into the verified set, counted once)."""
        if h in self._verified_blobs or h in self._known_chunks:
            return True
        if not self.store.has_blob(h):
            return False
        if sha256_hex(self.store.read_blob(h)) != h:
            return False
        self._verified_blobs.add(h)
        self.stats.blobs_hashed_remote += 1
        self.store.ensure_blob_durable(h)    # adopted orphan: re-arm fsync
        return True

    # -------------------------------------------------------------- commit
    def commit(self, manifest: Manifest, config: ImageConfig) -> PushStats:
        """Incremental verification, then the manifest rename.

        * committed pre-existing layer: checksum must equal the incoming
          config lock (same id + diverged checksum = the paper's in-place
          mutation — rejected). Its blobs were verified when ITS push
          committed; never re-hashed.
        * re-keyed clone: received descriptor's records must hash (metadata
          content checksum) to the SAME checksum as the already-held twin —
          content identical, so every blob is already present and verified.
        * new-content layer (received, or an on-disk orphan of a crashed
          push): deep incremental check — records must match checksum and
          config lock, and every chunk must pass ``_blob_ok`` (verified on
          receipt, committed-known, or re-hashed now). Outside the
          crash-recovery case no byte is ever hashed twice.
        * all layers: the chain checksums are re-keyed and re-checked
          link by link (metadata-only), so the re-key walk the source did
          is independently recomputed at the remote.

        Pre-existing layers and re-key twins may have been committed under
        a DIFFERENT image name (the cross-image universe) — the checks are
        identical either way, because they compare content checksums, not
        namespaces; a twin is only trusted if ITS id is committed-reachable
        somewhere, never because its descriptor file merely exists.

        Crash/retry contract: every verification failure raises
        ``PushRejected`` BEFORE ``write_image`` — the store's previous
        tags stay authoritative, and a retry re-pushes through the normal
        orphan-recovery path. The manifest rename inside ``write_image``
        is the single commit point (deferred batch fsyncs flush just
        before it). Counters: ``layers_dedup`` / ``layers_rekey_verified``
        / ``layers_deep_verified`` split the verification classes —
        CI gates that only genuinely-new-content layers are deep-verified.
        """
        stats = self.stats
        fault_point("wire.commit", self.store.root)
        if self._committed_layers is None:       # offline path: no negotiate
            self._scan_committed(manifest.name)
        parent_chain: Optional[str] = None
        for lid in manifest.layer_ids:
            received = self._received_layers.get(lid)
            if received is None and lid in self._committed_layers and \
                    self.store.has_layer(lid):
                layer = self.store.read_layer(lid)
                want = config.layer_checksums.get(lid)
                if layer.checksum != want:
                    raise PushRejected(
                        f"layer {lid}: remote holds a different checksum "
                        "trace for this id (in-place mutation without a "
                        "new id?)")
                stats.layers_dedup += 1
            else:
                if received is None:
                    # an on-disk descriptor NOT reachable from a committed
                    # manifest is an orphan of a crashed push: re-verify it
                    # like a received layer, never trust it
                    if not self.store.has_layer(lid):
                        raise PushRejected(f"layer {lid}: neither received "
                                           "nor already held")
                    layer = self.store.read_layer(lid, use_cache=False)
                else:
                    layer = received
                if content_checksum(layer.records) != layer.checksum or \
                        config.layer_checksums.get(lid) != layer.checksum:
                    raise PushRejected(
                        f"layer {lid}: received records do not match the "
                        "declared checksum/lock")
                # a re-key twin is only trustworthy if IT was verified by a
                # committed push — an orphan descriptor must not vouch
                twin_id = self.rekey.get(lid)
                twin = (self.store.read_layer(twin_id)
                        if twin_id and twin_id in self._committed_layers
                        and self.store.has_layer(twin_id)
                        else None)
                if twin is not None and twin.checksum == layer.checksum:
                    # content-identical clone of an already-verified layer
                    stats.layers_rekey_verified += 1
                else:
                    for rec in layer.records:
                        for h in rec.chunks:
                            if not self._blob_ok(h):
                                raise PushRejected(
                                    f"layer {lid}: missing or corrupt "
                                    f"blob {h[:12]}")
                    stats.layers_deep_verified += 1
            expected = chain_checksum(parent_chain, layer.checksum,
                                      layer.instruction.text)
            if expected != layer.chain or \
                    config.layer_chains.get(lid) != layer.chain:
                raise PushRejected(f"layer {lid}: chain re-key mismatch")
            parent_chain = layer.chain

        cfg_bytes = dumps(config.to_json()).encode()
        man_bytes = dumps(manifest.to_json()).encode()
        stats.bytes_meta += len(cfg_bytes) + len(man_bytes)
        # the manifest rename: batch-durability fsyncs coalesce here
        self.store.write_image(manifest, config)
        stats.bytes_sent = stats.bytes_payload + stats.bytes_meta
        return stats


_TRANSFER_BATCH = 32    # blobs in flight per pipeline wave


@dataclass
class ReplicaResult:
    """One destination's outcome in a fan-out: its PushStats on success,
    the captured failure otherwise. Failures are ISOLATED — a replica that
    rejects, corrupts a transfer or dies never blocks the others; a later
    ``replicate_fanout`` retry converges it (orphan blobs/descriptors are
    re-verified by the normal negotiate/probe crash-recovery path).

    ``stats`` is only set for replicas that COMMITTED. A replica that
    failed mid-push still reports what actually crossed the wire before it
    dropped out in ``stats_partial`` — bytes of waves never sent to it are
    never counted anywhere; a within-run retry (``retry=`` on
    ``replicate_fanout``) that later converges it sets ``stats`` to the
    SUCCESSFUL attempt's books while ``stats_partial`` keeps the first
    failure's, so "the retry paid only the remainder" is checkable.
    ``health`` records the retry loop's outcome (attempts, backoff,
    quarantine) whenever one ran. ``children`` nests the downstream tier's
    outcome when this replica is a ``RelayNode``."""

    stats: Optional[PushStats] = None
    error: Optional[str] = None
    exception: Optional[BaseException] = None
    stats_partial: Optional[PushStats] = None
    children: Optional["FanoutStats"] = None
    health: Optional[RetryHealth] = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class FanoutStats:
    """What one fan-out replication actually cost the SOURCE, plus the
    per-replica outcomes. ``negotiation_rounds`` and ``source_blob_reads``
    are the paper-style structural claims CI gates: the source walks its
    layer metadata once and reads each changed blob from its store exactly
    once, no matter how many replicas are behind."""

    replicas: List[ReplicaResult] = field(default_factory=list)
    negotiation_rounds: int = 0
    source_blob_reads: int = 0
    # unique blobs actually SHIPPED to at least one replica. Counted at
    # ship time, never precomputed: when a replica drops out between
    # transfer waves, blobs whose only taker died are neither read nor
    # counted — source_blob_reads == blobs_broadcast stays exact.
    blobs_broadcast: int = 0
    wall_s: float = 0.0
    # Self-healing accounting (retry= passed): replica indices that
    # exhausted their attempts this run (their ReplicaResult.health holds
    # the structured record), and the total extra attempts spent across
    # the fleet. A quarantined replica is left for the NEXT replication
    # cycle (or an operator) — never retried forever in-line.
    quarantined: List[int] = field(default_factory=list)
    retries_spent: int = 0

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.replicas)

    @property
    def n_ok(self) -> int:
        return sum(1 for r in self.replicas if r.ok)

    @property
    def majority_ok(self) -> bool:
        """Graceful degradation floor: more than half the fleet committed
        this tag."""
        return self.n_ok * 2 > len(self.replicas)

    @property
    def deep_ok(self) -> bool:
        """ok across EVERY tier: this one and, for relay replicas, the
        whole downstream topology."""
        return all(r.ok and (r.children is None or r.children.deep_ok)
                   for r in self.replicas)


def _as_receiver(r) -> "DeltaReceiver":
    """Remotes come in three shapes: a live receiver (RelayNode / reused
    DeltaReceiver), a LayerStore, or a filesystem path."""
    if isinstance(r, DeltaReceiver):
        return r
    return DeltaReceiver(r if isinstance(r, LayerStore) else
                         LayerStore(str(r)))


class RelayNode(DeltaReceiver):
    """A relay tier: one store that is simultaneously a ``DeltaReceiver``
    (pulls a delta from its parent) and a fan-out source (re-fans the SAME
    negotiated plan to its children).

    The parent's delta header seeds the child tier: ``negotiate`` answers
    the parent with the relay's own have-set AND forwards the identical
    O(#layers) request to every child, and ``probe_blobs`` re-uses the
    parent's chunk probe list as the child probe — the relay never
    re-derives negotiation from scratch, and every tier still pays exactly
    one negotiation round. The union of the child answers splits into two
    plans:

    * **from-parent** blobs (the relay is missing them too): each one
      arrives exactly once via ``receive_blob`` — content-address-verified
      on receipt — and, with ``source="inflight"`` (the default), is
      forwarded to every child missing it straight from the wire buffer:
      zero local reads, zero relay-side re-hashing, bytes stream downstream
      while the relay's own pull is still in flight. ``source="commit"``
      defers the forward until the relay has committed (one local read per
      blob, still never one per child).
    * **serve-local** blobs (the relay already holds them — children
      staler than the relay, or re-key/dedup twins): read from the relay's
      store exactly ONCE each at fan time and broadcast to every child
      that lacks them, no matter how many children there are.

    Atomicity is tiered: children receive bytes early, but a child
    ``commit`` only ever runs AFTER the relay's own commit succeeded —
    a relay that fails (or dies) mid-pull leaves every child at its
    previous tag with only orphan blobs behind, and a fleet-wide retry
    converges through the normal orphan re-verification path. Child
    failures are isolated per child (``fan.replicas``) and never poison
    the relay's own pull. Children may themselves be ``RelayNode``s —
    tiers nest arbitrarily deep.

    **Retention leases** close the ROADMAP prune-vs-lagging-child race: at
    ``negotiate`` the relay takes a ref-count lease (per child, TTL
    ``lease_ttl_s``) on every tag its store currently holds — across
    EVERY image, since cross-image holdings can vouch for the pull — the
    base revisions a lagging child's delta resumes from. Retention
    (``ckpt.prune_steps`` -> ``LayerStore.remove_image``) refuses to
    collect a leased tag. A child's leases are released the moment it
    COMMITS (it no longer needs any base) and simply expire if the child
    died — so a dead edge can never pin the relay's disk forever, and a
    live lagging one can never have its base pruned out from under it.

    ``retry=`` (a ``ft.RetryPolicy``) makes the re-fan self-healing: a
    child that failed its first fan is re-pushed from the relay's own
    committed store with backoff, resuming from whatever bytes already
    landed (orphan adoption); a child that exhausts its attempts is
    quarantined on ``fan.quarantined`` with its ``RetryHealth``.

    Crash/retry contract in one line: nothing downstream of a tier ever
    commits unless that tier committed first, and every partial state a
    crash can leave (orphan blobs/descriptors, unexpired leases, unflushed
    batch fsyncs) is re-verified or expires on the next push — observable
    through exactly these counters: ``fan.negotiation_rounds``, ``inflight_blobs``,
    ``local_blob_reads``, per-child ``ReplicaResult.stats(_partial)`` and
    ``RetryHealth``.
    """

    LEASE_TTL_S = 600.0

    def __init__(self, store, children: Sequence = (),
                 source: str = "inflight",
                 retry: Optional[RetryPolicy] = None,
                 lease_ttl_s: float = LEASE_TTL_S):
        if source not in ("inflight", "commit"):
            raise ValueError(f"source must be 'inflight' or 'commit', "
                             f"got {source!r}")
        if isinstance(children, (str, bytes)):
            # a bare path would be iterated per CHARACTER, building one
            # junk store per char — always a caller bug
            raise TypeError("children must be a sequence of stores/paths/"
                            f"receivers, not a bare path: {children!r}")
        super().__init__(store if isinstance(store, LayerStore)
                         else LayerStore(str(store)))
        self.children: List[DeltaReceiver] = [_as_receiver(c)
                                              for c in children]
        self.source = source
        self.retry = retry
        self.lease_ttl_s = lease_ttl_s
        self._relay_lock = threading.Lock()
        self._begin_fan()

    def _lease_owner(self, i: int) -> str:
        """Stable per (this relay, child slot) across pushes and retries,
        so a retry refreshes the same lease instead of stacking new ones."""
        return f"relay-{id(self):x}/child-{i}"

    def begin_push(self) -> None:
        super().begin_push()
        # __init__ order: the first begin_push runs before children exist
        if hasattr(self, "children"):
            self._begin_fan()
            for child in self.children:
                child.begin_push()

    def override_source(self, mode: str) -> None:
        """Set THIS push's streaming mode for the whole subtree. The
        node's configured ``source`` is untouched — a later push without
        an override gets the configured mode back — and the override is
        cleared by the next ``begin_push``."""
        self._push_source = mode
        for child in self.children:
            if isinstance(child, RelayNode):
                child.override_source(mode)

    @property
    def effective_source(self) -> str:
        return self._push_source or self.source

    def _begin_fan(self) -> None:
        self._push_source: Optional[str] = None   # per-push mode override
        self.fan = FanoutStats(
            replicas=[ReplicaResult() for _ in self.children])
        self._child_missing: List[List[str]] = [[] for _ in self.children]
        # blob -> child indices. _inflight_want blobs arrive from the
        # parent; _local_want blobs are served from the relay's own store.
        self._inflight_want: Dict[str, Set[int]] = {}
        self._local_want: Dict[str, Set[int]] = {}
        self._forwarded: Set[str] = set()
        self.inflight_blobs = 0      # unique blobs forwarded pre-commit
        self.local_blob_reads = 0    # local store reads during the fan

    def all_stores(self):
        """Every store in this subtree (for batch-durability scoping)."""
        yield self.store
        for child in self.children:
            if isinstance(child, RelayNode):
                yield from child.all_stores()
            else:
                yield child.store

    def _child_ok(self, i: int) -> bool:
        return self.fan.replicas[i].error is None

    def _fail_child(self, i: int, exc: BaseException) -> None:
        with self._relay_lock:
            if self.fan.replicas[i].error is None:
                self.fan.replicas[i].error = f"{type(exc).__name__}: {exc}"
                self.fan.replicas[i].exception = exc
                self.fan.replicas[i].stats_partial = \
                    self.children[i].stats

    # ------------------------------------------------------------ negotiate
    def negotiate(self, name: str,
                  layer_meta: Dict[str, Tuple[str, str]]) -> HaveSet:
        """Answer the parent with the relay's own have-set, then seed every
        child with the SAME request. Child-missing layers whose content the
        relay can already serve (committed here, or content-identical to a
        committed re-key twin) get their chunk lists probed at the child
        now — those blobs never need the parent."""
        have = super().negotiate(name, layer_meta)
        # the relay's current tags are the base revisions a lagging child
        # resumes from: lease them per child BEFORE any plan is made, so a
        # concurrent/interleaved prune can never collect a base a child
        # still negotiates against. Cross-image holdings vouch now, so the
        # lease set spans EVERY image the relay holds — a child pulling
        # ``tenant3`` may be negotiating against blobs only ``base``
        # reaches. Released at that child's commit; expires if the child
        # dies mid-pull.
        held_tags = [(img, t) for img in self.store.list_images()
                     for t in self.store.list_tags(img)]
        for i in range(len(self.children)):
            for img, t in held_tags:
                self.store.acquire_lease(img, t, self._lease_owner(i),
                                         self.lease_ttl_s)
        for i, child in enumerate(self.children):
            try:
                ch = child.negotiate(name, layer_meta)
                child.stats.bytes_meta += ch.exchange_bytes
                # the mutation gate, per child, before any byte moves
                _gate_mutations(layer_meta, ch.held_checksums,
                                "child replica")
                self._child_missing[i] = list(ch.missing_layers)
                servable: Set[str] = set()
                for lid in ch.missing_layers:
                    if lid in ch.rekey:
                        continue      # child proves it holds the content
                    if self._committed_layers and \
                            lid in self._committed_layers and \
                            self.store.has_layer(lid):
                        src_lid = lid
                    else:
                        # relay re-keys lid to a committed twin: content
                        # identical, so the twin's chunk list IS lid's
                        src_lid = have.rekey.get(lid)
                    if src_lid is None or not self.store.has_layer(src_lid):
                        continue      # arrives from the parent instead
                    for rec in self.store.read_layer(src_lid).records:
                        servable.update(rec.chunks)
                if servable:
                    for h in child.probe_blobs(sorted(servable)):
                        self._local_want.setdefault(h, set()).add(i)
            except Exception as e:  # noqa: BLE001
                self._fail_child(i, e)
        return have

    def probe_blobs(self, chunk_ids: Sequence[str]) -> Set[str]:
        """The parent's probe list (chunks of relay-missing content
        layers) doubles as the child probe — the delta header seeding the
        child have-set union. A chunk a child lacks routes in-flight if the
        parent is about to send it, serve-local if the relay already holds
        it (cross-layer dedup)."""
        missing = super().probe_blobs(chunk_ids)
        for i, child in enumerate(self.children):
            if not self._child_ok(i):
                continue
            try:
                lacks = child.probe_blobs(chunk_ids)
            except Exception as e:  # noqa: BLE001
                self._fail_child(i, e)
                continue
            for h in lacks:
                want = self._inflight_want if h in missing \
                    else self._local_want
                want.setdefault(h, set()).add(i)
        return missing

    # ------------------------------------------------------------- receive
    def receive_blob(self, h: str, data: bytes) -> int:
        """Verify + write locally (the relay's own single hash of the
        byte), then — in-flight mode — forward the SAME wire buffer to
        every child missing it: no local re-read, no relay-side re-hash;
        each child runs its own verify-on-receipt."""
        n = super().receive_blob(h, data)
        if self.effective_source == "inflight" and h in self._inflight_want:
            with self._relay_lock:
                first = h not in self._forwarded
                self._forwarded.add(h)
                targets = [i for i in sorted(self._inflight_want[h])
                           if self.fan.replicas[i].error is None]
                if first and targets:
                    self.inflight_blobs += 1
            for i in targets:
                try:
                    self.children[i].receive_blob(h, data)
                except Exception as e:  # noqa: BLE001
                    self._fail_child(i, e)
        return n

    # -------------------------------------------------------------- commit
    def commit(self, manifest: Manifest, config: ImageConfig) -> PushStats:
        """The relay's own incremental verification + manifest rename
        first; only then does the child tier finalize — a failed or killed
        relay pull means no child ever commits."""
        stats = super().commit(manifest, config)
        self._fan_children(manifest, config)
        return stats

    def _layer_for(self, lid: str) -> LayerDescriptor:
        received = self._received_layers.get(lid)
        return received if received is not None else self.store.read_layer(lid)

    def _fan_children(self, manifest: Manifest, config: ImageConfig) -> None:
        t0 = time.perf_counter()
        # a relay that dies at the re-fan point: its own tag committed,
        # children receive nothing this round (retry/next poll converges)
        fault_point("relay.fan", self.store.root)
        # blobs still owed to children: the serve-local plan plus any
        # in-flight blobs not yet forwarded (source="commit", or a child
        # plan learned after the blob passed through). Blob-major: ONE
        # local read per blob, broadcast to every child that lacks it.
        pending: Dict[str, Set[int]] = {}
        for h, idxs in self._local_want.items():
            pending.setdefault(h, set()).update(idxs)
        for h, idxs in self._inflight_want.items():
            if h not in self._forwarded:
                pending.setdefault(h, set()).update(idxs)
        for h in sorted(pending):
            targets = [i for i in sorted(pending[h]) if self._child_ok(i)]
            if not targets:
                continue
            try:
                data = self.store.read_blob(h)
            except OSError as e:
                # a locally-unreadable blob (retention race, bad sector)
                # fails only the children that needed THAT blob — the
                # relay already committed and the other children proceed
                for i in targets:
                    self._fail_child(i, e)
                continue
            self.local_blob_reads += 1
            for i in targets:
                try:
                    self.children[i].receive_blob(h, data)
                except Exception as e:  # noqa: BLE001
                    self._fail_child(i, e)

        # image-wide totals for per-child dedup accounting (metadata only;
        # every descriptor is local post-commit)
        total_refs = total_payload = 0
        for lid in manifest.layer_ids:
            layer = self._layer_for(lid)
            total_refs += sum(len(rec.chunks) for rec in layer.records)
            total_payload += layer.nbytes

        encoded: Dict[str, bytes] = {}   # descriptors encoded ONCE for all
        for i, child in enumerate(self.children):
            if not self._child_ok(i):
                continue
            try:
                for lid in self._child_missing[i]:
                    layer = self._layer_for(lid)
                    if lid not in encoded:
                        encoded[lid] = dumps(layer.to_json()).encode()
                    child.receive_layer(layer, encoded=encoded[lid])
                st = child.commit(manifest, config)
                _stamp_dedup(st, total_refs, total_payload, t0)
                self.fan.replicas[i].stats = st
                if isinstance(child, RelayNode):
                    self.fan.replicas[i].children = child.fan
                # committed: this child needs no base revision anymore —
                # release the whole cross-image lease set it pinned
                self.store.release_lease(None, self._lease_owner(i))
            except Exception as e:  # noqa: BLE001
                self._fail_child(i, e)
        if self.retry is not None:
            _retry_failed(self.store, self.children, self.fan,
                          manifest.name, manifest.tag, None, self.retry,
                          on_converged=lambda i: self.store.release_lease(
                              None, self._lease_owner(i)))
        self.fan.negotiation_rounds = max(
            (c.negotiations for c in self.children), default=0)
        self.fan.source_blob_reads = self.local_blob_reads
        self.fan.blobs_broadcast = self.inflight_blobs + self.local_blob_reads
        self.fan.wall_s = time.perf_counter() - t0


def _retry_failed(src: LayerStore, receivers: Sequence, fan: FanoutStats,
                  name: str, tag: str, source: Optional[str],
                  retry: RetryPolicy, on_converged=None) -> None:
    """Self-heal the failed replicas of a fan-out WITHIN the run: each one
    gets up to ``retry.max_attempts - 1`` further single-destination pushes
    (the main pass was attempt 1) with exponential backoff between them.
    Every retry resumes from the replica's actual partial progress — blobs
    that landed before the failure are adopted by the orphan re-hash at
    ``probe_blobs``, never resent — so a retry pays only the remainder.
    A replica that exhausts its attempts (or the deadline) is QUARANTINED:
    indexed on ``fan.quarantined`` with the structured ``RetryHealth`` on
    its ``ReplicaResult``, left for the next replication cycle."""
    for i, rep in enumerate(fan.replicas):
        if rep.ok:
            continue
        health = RetryHealth(attempts=1)
        if rep.error:
            health.errors.append(rep.error)
        t0 = time.monotonic()
        for n in range(1, retry.max_attempts):
            delay = retry.backoff(n - 1)
            if retry.deadline_s is not None and \
                    time.monotonic() - t0 + delay > retry.deadline_s:
                health.deadline_exceeded = True
                break
            time.sleep(delay)
            health.backoff_total_s += delay
            health.attempts += 1
            health.retries += 1
            fan.retries_spent += 1
            try:
                sub = replicate_fanout(src, [receivers[i]], name, tag,
                                       source=source)
                r0 = sub.replicas[0]
                if not r0.ok:
                    raise r0.exception if r0.exception is not None \
                        else RuntimeError(r0.error)
            except Exception as e:      # noqa: BLE001 — retry loop
                health.record_error(e)
                rep.error = f"{type(e).__name__}: {e}"
                rep.exception = e
                continue
            rep.stats = r0.stats        # stats_partial keeps the FIRST
            rep.error = None            # failure's books: retry delta is
            rep.exception = None        # provably just the remainder
            rep.children = r0.children
            health.succeeded = True
            if on_converged is not None:
                on_converged(i)
            break
        health.wall_s = time.monotonic() - t0
        if not health.succeeded:
            health.quarantined = True
            fan.quarantined.append(i)
        rep.health = health


def replicate_fanout(src: LayerStore, remotes: Sequence,
                     name: str, tag: str,
                     source: Optional[str] = None,
                     retry: Optional[RetryPolicy] = None) -> FanoutStats:
    """Fan-out delta replication: push ``name:tag`` to N replicas with ONE
    negotiated have-set and ONE source read pass.

    * One negotiation round: every replica answers the same O(#layers)
      metadata request (``DeltaReceiver.negotiate`` + ``probe_blobs``);
      the answers are unioned into a single plan mapping each missing blob
      to the replicas that need it — replicas missing different subsets
      get per-replica send lists carved from that one plan.
    * One source read pass: each blob any replica is missing is read from
      the source store exactly once (``FanoutStats.source_blob_reads``)
      and broadcast through the pipelined read -> send -> verify -> write
      path, bounded in-flight batches keeping peak memory at O(batch);
      layer descriptors are serialized once for all replicas.
    * Per-replica isolation: negotiation, transfer and commit failures are
      captured per replica (``ReplicaResult``); healthy replicas commit
      regardless, commits run concurrently so one straggler doesn't hold
      the rest, and a clean retry converges the failed ones.

    ``remotes`` may mix stores/paths with ``RelayNode``s — a relay pulls
    like any replica and re-fans the same plan to its own children
    (``ReplicaResult.children`` nests the downstream outcome).
    ``source="inflight"`` makes every relay stream received bytes to its
    children while this pull is still in flight; ``source="commit"``
    defers the re-fan until each relay commits; ``None`` keeps each
    relay's own configured mode.

    Replicas already holding a SIBLING image dedup against it: the
    have-set answers from each replica's whole committed namespace, so
    fanning a fresh fine-tune to replicas that hold the base image ships
    only the adapter deltas (bench_multitenant counter-proves zero
    base-blob transfers).

    Crash/retry contract: the source is read-only throughout; each
    replica's exposure is the receiver contract above (nothing visible
    before its own manifest rename, orphans re-verified on retry), so
    killing this call at ANY point leaves every replica serving its
    previous tag. With ``retry=``, failed replicas are re-pushed in-run
    with backoff, resuming from their actual partial progress; exhausted
    ones are quarantined on ``FanoutStats.quarantined``. Counters:
    ``negotiation_rounds`` (must be 1), ``source_blob_reads`` ==
    ``blobs_broadcast`` (each changed blob read exactly once),
    ``retries_spent``, and per-replica ``ReplicaResult`` books.
    """
    if source not in (None, "inflight", "commit"):
        raise ValueError(f"source must be 'inflight' or 'commit', "
                         f"got {source!r}")
    if isinstance(remotes, (str, bytes)):
        raise TypeError("remotes must be a sequence of stores/paths/"
                        f"receivers, not a bare path: {remotes!r}")
    t0 = time.perf_counter()
    problems = src.verify_image(name, tag, deep=False)   # once, not per N
    if problems:
        raise PushRejected(f"source image fails verification: {problems}")
    manifest, config = src.read_image(name, tag)
    layers = {lid: src.read_layer(lid) for lid in manifest.layer_ids}
    layer_meta = {lid: (layer.family, layer.checksum)
                  for lid, layer in layers.items()}
    total_refs = sum(len(rec.chunks) for layer in layers.values()
                     for rec in layer.records)
    total_payload = sum(layer.nbytes for layer in layers.values())

    receivers = [_as_receiver(r) for r in remotes]
    fan = FanoutStats(replicas=[ReplicaResult() for _ in receivers])
    lock = threading.Lock()

    def fail(i: int, exc: BaseException) -> None:
        with lock:
            if fan.replicas[i].error is None:
                fan.replicas[i].error = f"{type(exc).__name__}: {exc}"
                # kept with its traceback: push_delta re-raises it, and a
                # transfer-failure frame pins at most ONE blob's bytes
                fan.replicas[i].exception = exc
                # what actually crossed the wire before the drop — never
                # the waves that were skipped after it
                fan.replicas[i].stats_partial = receivers[i].stats

    def alive(i: int) -> bool:
        return fan.replicas[i].error is None

    with contextlib.ExitStack() as stack:
        for recv in receivers:
            for s in (recv.all_stores() if isinstance(recv, RelayNode)
                      else (recv.store,)):
                stack.enter_context(_BatchScope(s))

        # ---- ONE negotiation round: same request to every replica (the
        # independent exchanges run concurrently — each one scans its own
        # replica's metadata), the answers unioned into one plan
        # (blob -> replicas missing it). negotiation_rounds is MEASURED
        # from the receivers' exchange counters, not asserted.
        missing_layers: List[List[str]] = [[] for _ in receivers]
        plans: Dict[int, Set[str]] = {}
        want: Dict[str, List[int]] = {}
        pool = hash_pool()
        if pool is not None and \
                threading.current_thread().name.startswith("repro-sha"):
            # nested fan-out (relay child retry runs inside commit, which
            # may itself execute on a pool worker): block-joining the
            # shared pool from one of its own threads can deadlock on a
            # small pool, so nested pushes run inline
            pool = None

        def plan(i: int) -> None:
            try:
                recv = receivers[i]
                recv.begin_push()          # re-arm a reused receiver
                if source is not None and isinstance(recv, RelayNode):
                    # per-push override for the WHOLE subtree; cleared by
                    # the next begin_push, so the node's configured mode
                    # survives for later source=None pushes
                    recv.override_source(source)
                have = recv.negotiate(name, layer_meta)
                recv.stats.bytes_meta += have.exchange_bytes
                # the mutation gate, BEFORE any byte moves
                _gate_mutations(layer_meta, have.held_checksums, "remote")
                # blob set-difference: only new-content layers' chunks
                need = sorted({h for lid in have.missing_layers
                               if lid not in have.rekey
                               for rec in layers[lid].records
                               for h in rec.chunks})
                missing_layers[i] = list(have.missing_layers)
                plans[i] = recv.probe_blobs(need) if need else set()
            except Exception as e:  # noqa: BLE001
                fail(i, e)

        if len(receivers) > 1 and pool is not None:
            for f in [pool.submit(plan, i) for i in range(len(receivers))]:
                f.result()
        else:
            for i in range(len(receivers)):
                plan(i)
        for i in sorted(plans):
            if not alive(i):
                continue
            for h in plans[i]:
                want.setdefault(h, []).append(i)
        fan.negotiation_rounds = max(
            (r.negotiations for r in receivers), default=0)

        # ---- ONE source read pass, broadcast on the pipelined transfer:
        # one pool task per blob reads it (exactly once) and verifies +
        # writes the first replica inline — reads of other blobs overlap
        # with SHA verification exactly as the single-destination pipeline
        # always did — while the remaining replicas' receives fan out as
        # their own pool tasks (SHA releases the GIL, so N replicas verify
        # in parallel). Bounded in-flight waves keep memory at O(batch),
        # not O(delta) — and never O(N x delta).
        hashes = sorted(h for h, targets in want.items()
                        if any(alive(i) for i in targets))

        def receive(i: int, h: str, data: bytes) -> None:
            if not alive(i):
                return
            try:
                receivers[i].receive_blob(h, data)
            except Exception as e:  # noqa: BLE001
                fail(i, e)

        recv_futures: List[Future] = []

        def ship(h: str) -> None:
            targets = [i for i in want[h] if alive(i)]
            if not targets:
                return              # every taker died mid-transfer
            try:
                data = src.read_blob(h)
            except OSError as e:
                # a source-side read failure fails THIS blob's takers —
                # not the whole fan: the retry pass re-reads and re-ships
                # just the remainder. CrashInjected (the pusher process
                # itself dying) is a RuntimeError and still propagates.
                for i in targets:
                    fail(i, e)
                return
            with lock:
                fan.source_blob_reads += 1
                fan.blobs_broadcast += 1
            if pool is not None:
                recv_futures.extend(pool.submit(receive, i, h, data)
                                    for i in targets[1:])
                receive(targets[0], h, data)
            else:
                for i in targets:
                    receive(i, h, data)

        for off in range(0, len(hashes), _TRANSFER_BATCH):
            wave = hashes[off:off + _TRANSFER_BATCH]
            if pool is None or len(wave) <= 1:
                for h in wave:
                    ship(h)
            else:
                for f in [pool.submit(ship, h) for h in wave]:
                    f.result()
            # all ships joined, so no more receives get scheduled: drain
            for f in recv_futures:
                f.result()
            recv_futures.clear()

        # ---- per-replica finalize: descriptors (encoded ONCE for all
        # replicas), incremental verification, the manifest commit —
        # concurrent across replicas so a straggler only delays itself.
        encoded: Dict[str, bytes] = {}
        for i in range(len(receivers)):
            if not alive(i):
                continue
            for lid in missing_layers[i]:
                if lid not in encoded:
                    encoded[lid] = dumps(layers[lid].to_json()).encode()

        def finalize(i: int) -> None:
            recv = receivers[i]
            for lid in missing_layers[i]:
                recv.receive_layer(layers[lid], encoded=encoded[lid])
            stats = recv.commit(manifest, config)
            _stamp_dedup(stats, total_refs, total_payload, t0)
            fan.replicas[i].stats = stats
            if isinstance(recv, RelayNode):
                fan.replicas[i].children = recv.fan

        def safe_finalize(i: int) -> None:
            try:
                finalize(i)
            except Exception as e:  # noqa: BLE001
                fail(i, e)

        live = [i for i in range(len(receivers)) if alive(i)]
        if len(live) > 1 and pool is not None:
            for f in [pool.submit(safe_finalize, i) for i in live]:
                f.result()
        else:
            for i in live:
                safe_finalize(i)
    if retry is not None:
        # batch scopes restored first: each retry attempt opens its own,
        # so a retried replica's fsyncs are flushed by ITS commit
        _retry_failed(src, receivers, fan, name, tag, source, retry)
    fan.wall_s = time.perf_counter() - t0
    return fan


def push_delta(src: LayerStore, dst: LayerStore, name: str, tag: str,
               retry: Optional[RetryPolicy] = None) -> PushStats:
    """O(changed-bytes) push (module docstring): the single-destination
    form of ``replicate_fanout`` — one have-set negotiation, only missing
    layers + blobs over the pipelined transfer, incremental remote
    verification at commit. Failures re-raise instead of being isolated
    (after ``retry`` converges or quarantines, when one is given)."""
    fan = replicate_fanout(src, [dst], name, tag, retry=retry)
    rep = fan.replicas[0]
    if rep.exception is not None:
        raise rep.exception
    return rep.stats


def pull_delta(src: LayerStore, dst: LayerStore, name: str, tag: str,
               retry: Optional[RetryPolicy] = None) -> PushStats:
    """Pull = push with the roles swapped: ``dst`` negotiates its own
    have-set against ``src`` and receives only the delta."""
    return push_delta(src, dst, name, tag, retry=retry)


# --------------------------------------------------------------- offline
def export_delta(src: LayerStore, name: str, tag: str,
                 base_tag: Optional[str] = None,
                 base_images: Sequence[str] = ()) -> bytes:
    """Self-checking offline bundle of ``name:tag`` relative to
    ``name:base_tag`` (everything, when base_tag is None) — the
    ``docker save`` analogue of ``push_delta`` for air-gapped moves.

    ``base_images`` adds cross-image bases: layers and chunks reachable
    from those sibling images' newest committed tags (the receiver's
    TAG_WINDOW, per image) are treated as already-held and left out of
    the bundle, so a fine-tune exported against its base image carries
    only the adapter delta. The hints ride the header
    (``DeltaBundle.base_images``); a receiver that doesn't hold those
    images re-receives whatever its own cross-image holdings can't
    vouch for — a wrong hint costs a rejected import, never a silently
    wrong image (every blob is content-address-verified on receipt)."""
    manifest, config = src.read_image(name, tag)
    new_layers = [src.read_layer(lid) for lid in manifest.layer_ids]
    base_layers: List[LayerDescriptor] = []
    if base_tag is not None:
        base_manifest, _ = src.read_image(name, base_tag)
        base_layers = [src.read_layer(lid)
                       for lid in base_manifest.layer_ids]
    for img in base_images:
        for i, t in enumerate(sorted(src.list_tags(img), reverse=True)):
            if i >= DeltaReceiver.TAG_WINDOW:
                break
            try:
                m, _ = src.read_image(img, t)
            except (OSError, ValueError, KeyError):
                continue
            base_layers.extend(src.read_layer(lid) for lid in m.layer_ids
                               if src.has_layer(lid))
    missing, rekey, chunks = diff_manifests(base_layers, new_layers)
    return encode_delta(DeltaBundle(
        name=name, tag=tag, base_tag=base_tag or "",
        manifest=manifest, config=config, layers=missing, rekey=rekey,
        blobs={h: src.read_blob(h) for h in sorted(chunks)},
        base_images=list(base_images)))


def import_delta(dst, data: bytes) -> PushStats:
    """Apply an offline bundle through the same receive + incremental
    verification path a live push uses (decode already content-address-
    verified every payload; the receiver re-verifies on receipt anyway —
    defense in depth, still only the new bytes).

    ``dst`` may be a LayerStore/path or a ``RelayNode`` — the offline form
    of the relay topology: the bundle's header (``DeltaBundle.layer_meta``
    + blob index) seeds the child negotiation exactly like a live parent's
    delta header would, so one sneaker-netted bundle re-fans to a whole
    edge tier with the usual one-read/one-forward accounting."""
    bundle = decode_delta(data)
    receiver = _as_receiver(dst)
    receiver.begin_push()                  # re-arm a reused receiver
    with contextlib.ExitStack() as stack:
        for s in (receiver.all_stores() if isinstance(receiver, RelayNode)
                  else (receiver.store,)):
            stack.enter_context(_BatchScope(s))
        if isinstance(receiver, RelayNode):
            # the negotiated path: scan committed holdings AND seed every
            # child with the bundle header's layer metadata

            def held(lid):
                # a descriptor orphaned (possibly torn) by a crashed push
                # must degrade to "unknown family", not crash the import
                try:
                    return receiver.store.read_layer(lid) \
                        if receiver.store.has_layer(lid) else None
                except (OSError, ValueError, KeyError):
                    return None

            meta = bundle.layer_meta(held=held)
            receiver.negotiate(bundle.name, meta)
            receiver.rekey = dict(bundle.rekey)
            # probe the bundle's payload UNION the carried layers' full
            # chunk lists: a child staler than the bundle's base may lack
            # chunks the bundle doesn't carry but the relay already holds
            # committed — exactly what a live parent's probe list covers
            probe = set(bundle.blobs)
            for layer in bundle.layers:
                for rec in layer.records:
                    probe.update(rec.chunks)
            receiver.probe_blobs(sorted(probe))
        else:
            # index committed holdings up front so receive_layer's
            # immutability gate and commit's twin checks apply exactly as
            # on the live path
            receiver._scan_committed(bundle.name)
            receiver.rekey = dict(bundle.rekey)
        for h in sorted(bundle.blobs):
            receiver.receive_blob(h, bundle.blobs[h])
        for layer in bundle.layers:
            receiver.receive_layer(layer)
        stats = receiver.commit(bundle.manifest, bundle.config)
    return stats


# -------------------------------------------------------------- squashing
#: squash_deltas holds both endpoint tags against retention while it reads
SQUASH_LEASE_TTL_S = 600.0


def squash_deltas(store: LayerStore, name: str, from_tag: str,
                  to_tag: str) -> DeltaBundle:
    """Merge the per-commit delta records between ``from_tag`` and
    ``to_tag`` into ONE static bundle — the OSTree static-delta move: a
    lagging edge pays one merged delta instead of k per-commit hops or
    the full-pull fall-through.

    The composition reads the delta records ``inject_image_multi``
    already writes into the config history (``history_delta_chain``) and
    chains the layer-identity maps end-to-end
    (``compose_delta_records``): a layer injected once and re-keyed k-1
    times squashes to one re-key-verified clone; a layer rewritten at
    every hop ships once, with its final bytes. The chunk payload is
    derived from the STORE (final carried layers' chunks minus
    everything reachable at ``from_tag``), never from the capped
    per-record chunk lists — so intermediate rewrites of the same chunk
    collapse to the final bytes by construction, and a truncated
    history record can't truncate the bundle. When the history chain is
    unrecoverable (``from_tag`` fell off the 64-entry cap, a full
    rebuild sits in the span) or a composed re-key disagrees with the
    config locks, it falls back to a store-level re-diff
    (``diff_manifests``) — same bundle, derived the expensive way.

    Both endpoint tags are leased for the duration so a concurrent
    ``prune_steps``/``gc`` can't sweep them mid-read. The result applies
    through the ordinary ``import_delta`` path and is bit-identity
    checkable with ``verify_squashed_bundle``."""
    owner = f"squash/{new_uuid()}"
    store.acquire_lease(name, from_tag, owner, SQUASH_LEASE_TTL_S)
    store.acquire_lease(name, to_tag, owner, SQUASH_LEASE_TTL_S)
    try:
        to_manifest, to_config = store.read_image(name, to_tag)
        from_manifest, from_config = store.read_image(name, from_tag)
        chain = history_delta_chain(to_config, name, from_tag)
        rekey: Dict[str, str] = {}
        carried: List[str] = []
        if chain is not None:
            origin = compose_delta_records(chain)
            from_ids = set(from_manifest.layer_ids)
            for lid in to_manifest.layer_ids:
                base_lid, changed = origin.get(lid, (lid, False))
                if lid not in origin:
                    if lid not in from_ids:
                        chain = None    # unexplained new layer: re-diff
                        break
                    continue            # untouched, id shared verbatim
                if changed or base_lid not in from_ids:
                    carried.append(lid)
                elif from_config.layer_checksums.get(base_lid) != \
                        to_config.layer_checksums.get(lid):
                    chain = None        # history contradicts the locks
                    break
                else:
                    rekey[lid] = base_lid
        if chain is None:
            base_layers = [store.read_layer(lid)
                           for lid in from_manifest.layer_ids]
            new_layers = [store.read_layer(lid)
                          for lid in to_manifest.layer_ids]
            missing, rekey, chunks = diff_manifests(base_layers, new_layers)
        else:
            # the bundle ships every layer whose ID the base lacks — a
            # re-keyed clone's descriptor still crosses (fresh id + chain
            # checksums), it just carries no chunk payload
            changed = set(carried)
            missing = [store.read_layer(lid) for lid in to_manifest.layer_ids
                       if lid in changed or lid in rekey]
            base_chunks: Set[str] = set()
            for lid in from_manifest.layer_ids:
                for rec in store.read_layer(lid).records:
                    base_chunks.update(rec.chunks)
            chunks = {h for layer in missing if layer.layer_id in changed
                      for rec in layer.records
                      for h in rec.chunks} - base_chunks
        return DeltaBundle(
            name=name, tag=to_tag, base_tag=from_tag,
            manifest=to_manifest, config=to_config, layers=missing,
            rekey=dict(rekey),
            blobs={h: store.read_blob(h) for h in sorted(chunks)})
    finally:
        store.release_lease(name, owner)


def verify_squashed_bundle(src: LayerStore, bundle: DeltaBundle) -> List[str]:
    """Bit-identity proof for a squashed bundle: seed a scratch store
    with a full export of the bundle's base tag, apply the bundle
    through the normal ``import_delta`` path, then ``verify_image(
    deep=True)`` AND byte-compare every reachable chunk against ``src``.
    Returns the problem list (empty = proven identical)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="squash-verify-")
    try:
        scratch = LayerStore(tmp, chunk_bytes=src.chunk_bytes)
        if bundle.base_tag:
            import_delta(scratch, export_delta(src, bundle.name,
                                               bundle.base_tag))
        import_delta(scratch, encode_delta(bundle))
        problems = scratch.verify_image(bundle.name, bundle.tag, deep=True)
        manifest, _ = src.read_image(bundle.name, bundle.tag)
        if manifest.layer_ids != scratch.read_image(
                bundle.name, bundle.tag)[0].layer_ids:
            problems.append("manifest layer order diverged")
        for lid in manifest.layer_ids:
            for rec in src.read_layer(lid).records:
                for h in rec.chunks:
                    if scratch.read_blob(h) != src.read_blob(h):
                        problems.append(f"chunk {h[:12]} bytes diverged")
        return problems
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class PassiveRegistry:
    """Static bundles + a signed index, published as plain files any dumb
    HTTP / object store can serve — no smart endpoint, no per-follower
    state, ZERO negotiation round-trips on the pull path.

    Layout under ``root`` (a directory, or a read-only ``http(s)://``
    base URL)::

        <root>/<image>/index.json                       signed BundleIndex
        <root>/<image>/bundles/<from>__<to>.rdb         encoded DeltaBundle
        <root>/<image>/bundles/full__<to>.rdb           full bundle

    Publishing writes bundle files FIRST and renames the index into
    place LAST, so a crash mid-publish leaves a stale-but-consistent
    index: readers either see the old advertisement or the complete new
    one, never a reference to a half-written bundle. Fetches verify the
    advertised size + sha256 before decoding (and ``decode_delta``
    re-verifies every payload) — a truncated or bit-rotted bundle is
    detected at the edge and merely skipped by the chain planner.

    Fault points (ft/faults.py): ``bundle.publish`` fires on every file
    the publisher writes, ``bundle.fetch`` on every file a reader pulls
    (keys ``<root>:<image>:<from>-><to>`` and ``<root>:<image>:index``)."""

    INDEX_NAME = "index.json"

    def __init__(self, root: str, key: bytes = b""):
        self.root = str(root)
        self.key = key
        self._http = self.root.startswith(("http://", "https://"))

    # ------------------------------------------------------------ layout
    def _join(self, *parts: str) -> str:
        if self._http:
            return "/".join([self.root.rstrip("/"), *parts])
        return os.path.join(self.root, *parts)

    @staticmethod
    def bundle_relpath(from_tag: str, to_tag: str) -> str:
        return f"bundles/{from_tag or 'full'}__{to_tag}.rdb"

    # ------------------------------------------------------------ reading
    def _read(self, *parts: str) -> bytes:
        if self._http:
            import urllib.request
            with urllib.request.urlopen(self._join(*parts)) as resp:
                return resp.read()
        with open(self._join(*parts), "rb") as f:
            return f.read()

    def read_index(self, name: str) -> BundleIndex:
        """Fetch + signature-verify the image's index. Raises OSError /
        ``DeltaFormatError`` — callers treat either as "no usable
        index", never as a fatal poll error."""
        raw = fault_point("bundle.fetch", key=f"{self.root}:{name}:index",
                          data=self._read(name, self.INDEX_NAME))
        return decode_index(raw, key=self.key)

    def fetch_bundle(self, name: str, entry: BundleEntry) -> bytes:
        """Fetch one advertised bundle and verify it against the index's
        size + content address BEFORE handing it to ``decode_delta`` —
        truncation, bit-rot and a publish that crashed mid-write all
        surface here as ``DeltaFormatError``."""
        key = f"{self.root}:{name}:{entry.from_tag or 'full'}->{entry.to_tag}"
        raw = fault_point("bundle.fetch", key=key,
                          data=self._read(name, *entry.path.split("/")))
        if len(raw) != entry.size or sha256_hex(raw) != entry.sha256:
            raise DeltaFormatError(
                f"bundle {entry.path} does not match its advertisement")
        return raw

    # --------------------------------------------------------- publishing
    def _write(self, relparts: Sequence[str], data: bytes) -> None:
        if self._http:
            raise ValueError("http registry roots are read-only")
        path = os.path.join(self.root, *relparts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())    # bytes durable BEFORE the rename —
            # a post-crash index must never advertise a torn bundle
        os.replace(tmp, path)       # readers see old bytes or new, never torn

    def publish_bundle(self, store: LayerStore, name: str, to_tag: str,
                       from_tag: str = "") -> BundleEntry:
        """Encode + write one bundle file (squashed when ``from_tag`` is
        given, full otherwise) and return its index entry. The entry
        advertises the hash of the INTENDED bytes, computed before the
        ``bundle.publish`` fault point — a corrupted write lands on disk
        but can never pass a reader's verification."""
        if from_tag:
            data = encode_delta(squash_deltas(store, name, from_tag, to_tag))
        else:
            data = export_delta(store, name, to_tag)
        entry = BundleEntry(from_tag=from_tag, to_tag=to_tag,
                            path=self.bundle_relpath(from_tag, to_tag),
                            size=len(data), sha256=sha256_hex(data))
        key = f"{self.root}:{name}:{from_tag or 'full'}->{to_tag}"
        self._write([name, *entry.path.split("/")],
                    fault_point("bundle.publish", key=key, data=data))
        return entry

    def publish_image(self, store: LayerStore, name: str, head_tag: str,
                      from_tags: Sequence[str] = (), full: bool = True
                      ) -> BundleIndex:
        """Publish ``head_tag`` as a full bundle plus one squashed bundle
        per ``from_tags`` entry, then atomically advance the signed
        index. Existing entries whose endpoint tags are still committed
        in ``store`` are carried forward (the per-commit chain stays
        advertised); entries referencing pruned tags or missing files
        are dropped — the retention-awareness half of the contract. A
        single bundle that fails to publish (a fault, a mid-squash
        prune) is skipped and simply not advertised; the index written
        at the end only ever names bundles that landed."""
        prior = []
        generation = 0
        try:
            old = decode_index(self._read(name, self.INDEX_NAME),
                               key=self.key)
            generation = old.generation
            prior = old.entries
        except (OSError, ValueError):
            pass
        entries: List[BundleEntry] = []
        for e in prior:
            if (e.from_tag, e.to_tag) == ("", head_tag) or \
                    (e.from_tag and e.from_tag in from_tags and
                     e.to_tag == head_tag):
                continue            # about to be republished
            if e.from_tag and not store.has_image(name, e.from_tag):
                continue            # base pruned at the source
            if not store.has_image(name, e.to_tag):
                continue            # target pruned at the source
            if not self._http and not os.path.exists(
                    self._join(name, *e.path.split("/"))):
                continue            # bundle file vanished
            entries.append(e)
        wanted = [(f, head_tag) for f in from_tags if f]
        if full:
            wanted.append(("", head_tag))
        for from_tag, to_tag in wanted:
            try:
                entries.append(self.publish_bundle(store, name, to_tag,
                                                   from_tag=from_tag))
            except CrashInjected:
                raise               # simulated publisher death
            except (ConnectionError, OSError, ValueError, KeyError):
                continue            # not advertised; index stays honest
        index = BundleIndex(image=name, head=head_tag,
                            generation=generation + 1, entries=entries)
        try:
            data = fault_point("bundle.publish",
                               key=f"{self.root}:{name}:index",
                               data=encode_index(index, key=self.key))
            self._write([name, self.INDEX_NAME], data)
        except CrashInjected:
            raise               # simulated publisher death
        except (ConnectionError, OSError):
            pass                # stale-but-consistent: readers keep the
                                # old advertisement; the next publish
                                # (or a restarted one) advances it
        return index

    def prune(self, store: LayerStore, name: str) -> int:
        """Drop index entries (and their bundle files) whose endpoint
        tags are no longer committed in ``store`` — the publisher-side
        retention sweep. Returns the number of entries dropped; safe to
        call from a ``LayerStore`` gc hook (see ``attach_gc``)."""
        try:
            index = decode_index(self._read(name, self.INDEX_NAME),
                                 key=self.key)
        except (OSError, ValueError):
            return 0
        keep, dropped = [], []
        for e in index.entries:
            alive = store.has_image(name, e.to_tag) and \
                (not e.from_tag or store.has_image(name, e.from_tag))
            (keep if alive else dropped).append(e)
        if not dropped:
            return 0
        index.entries = keep
        index.generation += 1
        if index.head and not store.has_image(name, index.head):
            index.head = max((e.to_tag for e in keep), default="")
        self._write([name, self.INDEX_NAME],
                    encode_index(index, key=self.key))
        for e in dropped:
            try:
                os.remove(self._join(name, *e.path.split("/")))
            except OSError:
                pass
        return len(dropped)

    def attach_gc(self, store: LayerStore, name: str) -> None:
        """Register the retention sweep as a ``store.gc()`` hook: every
        garbage collection also drops published bundles whose endpoint
        tags it swept (reported as ``bundles_pruned`` in the gc stats)."""
        store.add_gc_hook(
            lambda st: {"bundles_pruned": self.prune(st, name)})


# ---------------------------------------------------------------- repair
#: a RepairSession holds its image's tags against retention while it runs
REPAIR_LEASE_TTL_S = 600.0


class RepairFailed(RuntimeError):
    """Anti-entropy repair could not fully restore the image: at least one
    damaged blob or layer descriptor had no intact source among the given
    peers. Everything sourceable WAS repaired and flushed before this was
    raised; the rest stays quarantined (the image is visibly-incomplete,
    never silently-corrupt). The partial accounting rides on ``.report``;
    ``repair_image(..., force=True)`` returns that report instead of
    raising — the ``remove_image(force=)``-style explicit override for
    operators who want the partial heal plus the unsourced list."""

    def __init__(self, msg: str, report: "RepairReport"):
        super().__init__(msg)
        self.report = report


@dataclass
class RepairReport:
    """Wire-accounted outcome of one anti-entropy repair.

    ``bytes_pulled`` counts EVERY byte fetched from peers (including
    copies that failed re-verification and were discarded);
    ``damaged_bytes`` counts the bytes actually swapped in (good blob
    payloads + refetched descriptor encodings). Their ratio —
    ``wire_amplification`` — is the anti-entropy efficiency claim: repair
    pulls only the damaged bytes, so with healthy peers it sits at 1.0
    (the CI gate allows <= 1.25x for retried/rotten peer copies).
    ``quarantined`` lists blobs moved aside (bad bytes preserved for
    forensics); ``unsourced`` lists what no peer could supply.
    """

    name: str = ""
    tag: str = ""
    planned_blobs: int = 0        # blobs the plan found damaged/missing
    planned_layers: int = 0       # descriptors the plan found damaged
    repaired_blobs: int = 0
    repaired_layers: int = 0
    bytes_pulled: int = 0         # every peer byte fetched (incl. discards)
    damaged_bytes: int = 0        # bytes actually swapped in
    quarantined: List[str] = field(default_factory=list)
    unsourced: List[str] = field(default_factory=list)
    peer_used: Dict[str, str] = field(default_factory=dict)
    verified_clean: bool = False  # final verify_image(deep=True) ran clean
    wall_s: float = 0.0

    @property
    def wire_amplification(self) -> float:
        """bytes_pulled / damaged_bytes (1.0 = perfectly targeted pull)."""
        return self.bytes_pulled / max(self.damaged_bytes, 1)


class _StorePeer:
    """Repair-source adapter over anything holding a live ``LayerStore``:
    the store itself, a root path, or a ``DeltaReceiver``/``RelayNode``
    (anything with a ``.store``). Fetches never raise — a peer whose own
    copy is missing or unreadable simply returns None and the session
    tries the next peer."""

    def __init__(self, store: LayerStore, label: str = ""):
        self.store = store
        self.label = label or store.root

    def fetch_blob(self, h: str) -> Optional[bytes]:
        if not self.store.has_blob(h):
            return None
        try:
            return self.store.read_blob(h)
        except OSError:
            return None

    def fetch_layer(self, lid: str
                    ) -> Optional[Tuple[LayerDescriptor, bytes]]:
        if not self.store.has_layer(lid):
            return None
        try:
            layer = self.store.read_layer(lid, use_cache=False)
        except (OSError, ValueError, KeyError):
            return None
        return layer, dumps(layer.to_json()).encode()


class _BundlePeer:
    """Repair-source adapter over an offline ``DeltaBundle`` (or raw RDB1
    bytes) — the air-gapped case: a node with no live peer heals from the
    same bundle artifact that built the image."""

    def __init__(self, bundle: DeltaBundle, label: str = "bundle"):
        self.bundle = bundle
        self.label = label
        self._layers = {ly.layer_id: ly for ly in bundle.layers}

    def fetch_blob(self, h: str) -> Optional[bytes]:
        return self.bundle.blobs.get(h)

    def fetch_layer(self, lid: str
                    ) -> Optional[Tuple[LayerDescriptor, bytes]]:
        layer = self._layers.get(lid)
        if layer is None:
            return None
        return layer, dumps(layer.to_json()).encode()


def _as_peer(p):
    """Normalize any DeltaReceiver-shaped repair source to a peer adapter:
    LayerStore | root path | DeltaReceiver/RelayNode (``.store``) |
    DeltaBundle | encoded RDB1 bytes | an adapter passed through."""
    if isinstance(p, (_StorePeer, _BundlePeer)):
        return p
    if isinstance(p, DeltaBundle):
        return _BundlePeer(p)
    if isinstance(p, (bytes, bytearray)):
        return _BundlePeer(decode_delta(bytes(p)))
    if isinstance(p, LayerStore):
        return _StorePeer(p)
    if isinstance(p, str):
        return _StorePeer(LayerStore(p))
    store = getattr(p, "store", None)
    if isinstance(store, LayerStore):
        return _StorePeer(store, label=getattr(p, "name", "") or store.root)
    raise TypeError(f"cannot use {type(p).__name__} as a repair peer")


class RepairSession:
    """Anti-entropy repair of one committed image — the healing half of
    the scrub/repair loop (delta machinery in reverse: instead of pushing
    the bytes a peer lacks, pull exactly the bytes THIS store lost).

    ``plan()`` walks the image against its own config locks and finds the
    damaged set: layer descriptors whose content checksum or config lock
    no longer match, and blobs that are missing or fail re-hash (a
    ``ScrubReport`` narrows the re-hash to its listed candidates; without
    one the plan deep-walks the whole image). The plan takes a retention
    lease on the tag and pins every reachable blob/layer path against
    ``gc()`` — a half-repaired image must never be swept under the
    session (a corrupt descriptor under-marks, so without the pin gc
    would collect the good siblings of the damaged layer).

    ``run()`` then, under one batch-durability scope: (1) refetches
    damaged descriptors from the peers, accepting only copies that match
    the local config's checksum/chain locks, and deep-checks their chunk
    set; (2) quarantines every corrupt on-disk blob up front — from this
    point the store is visibly-incomplete, never silently-corrupt, which
    is exactly the SIGKILL invariant (a killed session leaves quarantined
    blobs plus possibly some already-verified replacements, both states a
    clean retry converges from); (3) pulls only the damaged blobs,
    re-verifying each against its content address on receipt (a peer
    whose copy is ALSO rotten is skipped — any-peer repair); (4) flushes
    via the scope's ``sync_for_commit`` and deep-verifies the image.
    Blobs no peer could source are reported ``unsourced`` and the session
    raises ``RepairFailed`` unless ``force=True``.
    """

    def __init__(self, store: LayerStore, name: str, tag: str, peers,
                 scrub_report=None):
        self.store = store
        self.name = name
        self.tag = tag
        self.peers = [_as_peer(p) for p in peers]
        self.scrub_report = scrub_report
        self.owner = f"repair/{new_uuid()}"
        self.report = RepairReport(name=name, tag=tag)
        self.manifest: Optional[Manifest] = None
        self.config: Optional[ImageConfig] = None
        self.damaged_blobs: List[str] = []
        self.damaged_layers: List[str] = []
        self._protected: set = set()
        self._planned = False

    # ------------------------------------------------------------- planning
    def _layer_ok(self, lid: str) -> Tuple[bool, Optional[LayerDescriptor]]:
        st = self.store
        if not st.has_layer(lid):
            return False, None
        try:
            layer = st.read_layer(lid, use_cache=False)
        except (OSError, ValueError, KeyError):
            return False, None
        ok = (layer.layer_id == lid
              and content_checksum(layer.records) == layer.checksum
              and self.config.layer_checksums.get(lid) == layer.checksum
              and self.config.layer_chains.get(lid) == layer.chain)
        return ok, layer if ok else None

    def plan(self) -> "RepairSession":
        """Find the damaged set, lease the tag, pin the image's reach."""
        st = self.store
        try:
            self.manifest, self.config = st.read_image(self.name, self.tag)
        except (OSError, ValueError, KeyError) as e:
            raise RepairFailed(
                f"{self.name}:{self.tag} manifest/config unreadable — "
                f"nothing to anchor a repair to ({e})", self.report)
        st.acquire_lease(self.name, self.tag, self.owner,
                         REPAIR_LEASE_TTL_S)
        listed = None
        if self.scrub_report is not None:
            listed = set(self.scrub_report.corrupt_blob_hashes)
        damaged_blobs: set = set()
        damaged_layers: List[str] = []
        protect: set = set()
        for lid in self.manifest.layer_ids:
            protect.add(st._layer_path(lid))
            ok, layer = self._layer_ok(lid)
            if not ok:
                damaged_layers.append(lid)
                continue
            for rec in layer.records:
                for h in rec.chunks:
                    protect.add(st._blob_path(h))
                    if not st.has_blob(h):
                        damaged_blobs.add(h)
                    elif (listed is None or h in listed) and \
                            sha256_hex(st.read_blob(h)) != h:
                        damaged_blobs.add(h)
        if damaged_layers:
            # an unreadable descriptor hides its chunk list, so the
            # damaged layer's reach cannot be enumerated — and gc's mark
            # phase is blinded the same way. Pin every on-disk blob until
            # the descriptor is refetched (run() narrows the pin to the
            # real chunk set as soon as it has one); without this, a
            # concurrent gc would sweep the damaged layer's GOOD blobs
            # out from under the session.
            blob_root = os.path.join(st.root, "blobs", "sha256")
            if os.path.isdir(blob_root):
                for sub in sorted(os.listdir(blob_root)):
                    d = os.path.join(blob_root, sub)
                    if os.path.isdir(d):
                        protect.update(os.path.join(d, fn)
                                       for fn in os.listdir(d))
        st.protect_paths(protect)
        self._protected = set(protect)
        self.damaged_blobs = sorted(damaged_blobs)
        self.damaged_layers = damaged_layers
        self.report.planned_blobs = len(self.damaged_blobs)
        self.report.planned_layers = len(self.damaged_layers)
        self._planned = True
        return self

    # ------------------------------------------------------------ execution
    def _refetch_layers(self, pending: set) -> None:
        """Refetch damaged descriptors, validated against the LOCAL config
        locks (the config is the trust anchor — a peer cannot swap in a
        descriptor our committed config never vouched for), then extend
        ``pending`` with any of their chunks that are missing or rotten
        here."""
        st, rep = self.store, self.report
        for lid in self.damaged_layers:
            fetched = False
            for peer in self.peers:
                got = peer.fetch_layer(lid)
                if got is None:
                    continue
                layer, enc = got
                rep.bytes_pulled += len(enc)
                if (layer.layer_id != lid
                        or content_checksum(layer.records) != layer.checksum
                        or self.config.layer_checksums.get(lid)
                        != layer.checksum
                        or self.config.layer_chains.get(lid) != layer.chain):
                    continue        # peer's copy diverges from our locks
                chunk_paths = {st._blob_path(h)
                               for r in layer.records for h in r.chunks}
                st.protect_paths(chunk_paths)
                self._protected |= chunk_paths
                st.write_layer(layer, encoded=enc)
                rep.damaged_bytes += len(enc)
                rep.repaired_layers += 1
                rep.peer_used[lid] = peer.label
                for r in layer.records:
                    for h in r.chunks:
                        if not st.has_blob(h):
                            pending.add(h)
                        elif sha256_hex(st.read_blob(h)) != h:
                            pending.add(h)
                fetched = True
                break
            if not fetched:
                rep.unsourced.append(f"layer:{lid}")

    def run(self, force: bool = False) -> RepairReport:
        """Execute the repair (planning first if needed). Returns the
        report; raises ``RepairFailed`` when anything stayed unsourced and
        ``force`` is False. Lease and gc pins are always released."""
        t0 = time.perf_counter()
        st, rep = self.store, self.report
        try:
            if not self._planned:
                self.plan()
            with _BatchScope(st):
                pending = set(self.damaged_blobs)
                self._refetch_layers(pending)
                # quarantine first: every pending blob still on disk is a
                # failed re-hash — move the bad bytes out of the namespace
                # BEFORE pulling (write_blob dedups on existence, and a
                # SIGKILL here must leave visibly-incomplete, not
                # silently-corrupt)
                for h in sorted(pending):
                    if st.has_blob(h) and st.quarantine_blob(h):
                        rep.quarantined.append(h)
                for h in sorted(pending):
                    data = None
                    src_label = ""
                    for peer in self.peers:
                        raw = peer.fetch_blob(h)
                        if raw is None:
                            continue
                        raw = fault_point("repair.pull",
                                          f"{st.root}:{h}", raw)
                        rep.bytes_pulled += len(raw)
                        if sha256_hex(raw) != h:
                            continue    # peer's copy is ALSO rotten
                        data, src_label = raw, peer.label
                        break
                    if data is None:
                        rep.unsourced.append(h)
                        continue
                    st.write_blob(h, data)
                    rep.damaged_bytes += len(data)
                    rep.repaired_blobs += 1
                    rep.peer_used[h] = src_label
                # crash window probe: quarantines + swap-ins happened,
                # the durability flush has not (SIGKILL tests kill here)
                fault_point("repair.commit", st.root)
            if not rep.unsourced:
                rep.verified_clean = \
                    st.verify_image(self.name, self.tag, deep=True) == []
            rep.wall_s = time.perf_counter() - t0
            if rep.unsourced and not force:
                raise RepairFailed(
                    f"{self.name}:{self.tag}: {len(rep.unsourced)} "
                    f"item(s) unsourceable from {len(self.peers)} peer(s) "
                    f"(quarantined, image left visibly-incomplete): "
                    f"{rep.unsourced[:4]}", rep)
            return rep
        finally:
            st.unprotect_paths(self._protected)
            st.release_lease(self.name, self.owner, self.tag)


def repair_image(store: LayerStore, name: str, tag: str, peers,
                 scrub_report=None, force: bool = False) -> RepairReport:
    """Heal ``name:tag`` in ``store`` from any peer holding good copies —
    see ``RepairSession``. ``peers`` accepts any mix of live stores, root
    paths, ``DeltaReceiver``/``RelayNode`` fronts, ``DeltaBundle``s or
    encoded bundle bytes; they are tried in order per damaged item.
    ``scrub_report`` narrows the damage plan to the scrub's findings;
    ``force=True`` returns a partial report instead of raising when some
    items have no intact source anywhere."""
    return RepairSession(store, name, tag, peers,
                         scrub_report=scrub_report).run(force=force)
