"""DeltaBundle — the O(changed-bytes) redeployment wire format (torch port
of ``repro/core/delta.py``; bundles and indexes are byte-identical).

Every batched injection commit (``inject_image_multi``) changes an image by
a small, precisely-known delta: the injected chunk blobs, the cloned-layer
descriptors, the downstream re-key table and a fresh manifest/config. A
``DeltaBundle`` packages exactly that — nothing else crosses the wire on a
push — which is what turns §III.C redeployment from O(image) into
O(changed bytes) (cf. Charliecloud's pack-style build-cache transfer,
arXiv:2309.00166).

Wire layout (``encode_delta``/``decode_delta``)::

    b"RDB1" | uint64 header_len | header JSON | blob payloads (index order)

The header carries the manifest, config, layer descriptors, the re-key
table ({new_layer_id: remote_layer_id} for content-identical clones), the
cross-image base hints (``base_images`` — sibling images the delta was
computed against, e.g. the base model a fine-tune forked from) and a
blob index [[sha256, length], ...]; payloads follow concatenated in index
order. Decoding verifies each payload against its content address, so a
bundle is self-checking — the receiving side never has to trust lengths or
offsets.

``core.diff.diff_manifests`` computes the delta between two *stored* images
at the metadata level (family + content-checksum matching): the basis for
offline bundles (``registry.export_delta``) when no live remote is
available to negotiate a have-set with.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .chunker import sha256_hex
from .manifest import ImageConfig, LayerDescriptor, Manifest, dumps

_MAGIC = b"RDB1"


class DeltaFormatError(ValueError):
    """Raised when a bundle fails structural or content-address checks."""


@dataclass
class DeltaBundle:
    """One image transition, self-contained: apply on top of whatever the
    receiver already holds (``rekey`` names the holdings it may reuse)."""

    name: str
    tag: str                            # the tag this bundle produces
    base_tag: str = ""                  # provenance only ("" = unknown/full)
    manifest: Manifest = None
    config: ImageConfig = None
    layers: List[LayerDescriptor] = field(default_factory=list)
    # new_layer_id -> layer_id the receiver already holds with the SAME
    # content checksum (a re-keyed clone): receiving side can skip deep
    # verification for these — content identical, only the chain moved.
    rekey: Dict[str, str] = field(default_factory=dict)
    blobs: Dict[str, bytes] = field(default_factory=dict)
    # Cross-image base hints: sibling image names the delta was ALSO
    # computed against (registry.export_delta's ``base_images``). Layers
    # and chunks reachable from those images' committed tags are omitted
    # from the bundle — a fine-tune's bundle carries only adapter deltas
    # when the receiver holds the base under another name. Purely
    # advisory provenance for the receiver: its own cross-image holdings
    # index answers the have-set either way, so an old decoder (or an
    # empty list) only costs bundle size, never correctness.
    base_images: List[str] = field(default_factory=list)

    @property
    def payload_bytes(self) -> int:
        return sum(len(b) for b in self.blobs.values())

    def layer_meta(self, held=None) -> Dict[str, tuple]:
        """{layer_id: (family, content_checksum)} for EVERY manifest layer,
        in manifest order — the negotiation request a live push derives
        from its source store, reconstructed from the bundle header so an
        offline relay (``registry.import_delta`` at a ``RelayNode``) can
        seed its children with the same have-set exchange. Families of
        layers the bundle doesn't carry come from ``held`` (a lookup
        returning the receiver's own descriptor, or None); a layer known
        to neither side keeps the config's checksum lock with an empty
        family, which only costs a missed re-key match downstream, never
        correctness."""
        carried = {layer.layer_id: layer for layer in self.layers}
        meta: Dict[str, tuple] = {}
        for lid in self.manifest.layer_ids:
            layer = carried.get(lid)
            if layer is None and held is not None:
                layer = held(lid)
            meta[lid] = (layer.family, layer.checksum) if layer is not None \
                else ("", self.config.layer_checksums.get(lid, ""))
        return meta


def encode_delta(bundle: DeltaBundle) -> bytes:
    index = sorted(bundle.blobs.keys())
    header = {
        "name": bundle.name,
        "tag": bundle.tag,
        "base_tag": bundle.base_tag,
        "base_images": list(bundle.base_images),
        "manifest": bundle.manifest.to_json(),
        "config": bundle.config.to_json(),
        "layers": [layer.to_json() for layer in bundle.layers],
        "rekey": dict(bundle.rekey),
        "blob_index": [[h, len(bundle.blobs[h])] for h in index],
    }
    head = dumps(header).encode()
    parts = [_MAGIC, struct.pack("<Q", len(head)), head]
    parts.extend(bundle.blobs[h] for h in index)
    return b"".join(parts)


def decode_delta(data: bytes) -> DeltaBundle:
    if len(data) < 12 or data[:4] != _MAGIC:
        raise DeltaFormatError("not a delta bundle (bad magic / truncated)")
    (head_len,) = struct.unpack("<Q", data[4:12])
    if 12 + head_len > len(data):
        raise DeltaFormatError("truncated bundle header")
    header = json.loads(data[12:12 + head_len])
    blobs: Dict[str, bytes] = {}
    off = 12 + head_len
    for h, length in header["blob_index"]:
        piece = data[off:off + length]
        if len(piece) != length:
            raise DeltaFormatError(f"truncated payload for blob {h[:12]}")
        if sha256_hex(piece) != h:
            raise DeltaFormatError(f"payload does not match address {h[:12]}")
        blobs[h] = piece
        off += length
    if off != len(data):
        raise DeltaFormatError("trailing bytes after last payload")
    manifest = Manifest.from_json(header["manifest"])
    return DeltaBundle(
        name=header["name"],
        tag=header["tag"],
        base_tag=header.get("base_tag", ""),
        base_images=list(header.get("base_images", [])),
        manifest=manifest,
        config=ImageConfig.from_json(header["config"]),
        layers=[LayerDescriptor.from_json(d) for d in header["layers"]],
        rekey=dict(header.get("rekey", {})),
        blobs=blobs,
    )


# --------------------------------------------------------------- squashing

def compose_delta_records(records: Sequence[dict]) -> Dict[str, Tuple[str, bool]]:
    """Chain a contiguous run of per-commit delta records end-to-end.

    Each record (``injection_history_entry``'s ``delta``) maps
    ``{new_layer_id: old_layer_id}`` three ways — ``injected`` and
    ``rederived`` (content changed) and ``rekeyed`` (content identical,
    only the chain checksum moved). Composing the run means following
    each layer's identity through every hop: a layer injected at hop 2
    and re-keyed at hops 3..k is ONE content change against the base,
    and a layer only ever re-keyed is none at all.

    Returns ``{final_layer_id: (base_layer_id, content_changed)}`` for
    every layer id touched anywhere in the run, keyed by the id it ends
    the run with. Layers absent from the map were never touched (their
    id is shared with the base verbatim). Intermediate hops' chunk lists
    are deliberately NOT composed here — ``squash_deltas`` derives the
    final chunk set from the store so same-chunk overwrites collapse to
    the final bytes by construction (the capped per-record chunk lists
    are advisory)."""
    origin: Dict[str, Tuple[str, bool]] = {}
    for record in records:
        step: Dict[str, Tuple[str, bool]] = {}
        for kind, changes in (("injected", True), ("rederived", True),
                              ("rekeyed", False)):
            for new, old in (record.get(kind) or {}).items():
                base, changed = origin.pop(old, (old, False))
                step[new] = (base, changed or changes)
        origin.update(step)
    return origin


# ------------------------------------------------------------ bundle index

INDEX_VERSION = 1


@dataclass
class BundleEntry:
    """One published static bundle: apply on ``from_tag`` to reach
    ``to_tag``. ``from_tag == ""`` is a FULL bundle — applicable from
    nothing (and therefore from any state). ``path`` is relative to the
    image's directory in the passive registry; ``size``/``sha256`` are
    the advertised wire cost and the content address a fetcher must
    verify before decoding."""

    from_tag: str
    to_tag: str
    path: str
    size: int
    sha256: str

    def to_json(self) -> dict:
        return {"from": self.from_tag, "to": self.to_tag,
                "path": self.path, "size": int(self.size),
                "sha256": self.sha256}

    @staticmethod
    def from_json(d: dict) -> "BundleEntry":
        return BundleEntry(from_tag=str(d["from"]), to_tag=str(d["to"]),
                           path=str(d["path"]), size=int(d["size"]),
                           sha256=str(d["sha256"]))


@dataclass
class BundleIndex:
    """The passive registry's advertisement for one image: which (from,
    to) bundles exist, at what byte cost, plus the head tag the
    publisher most recently completed. Plain signed JSON a dumb HTTP /
    object store serves as a file — the whole point is that followers
    plan their pull from this document alone, with zero negotiation
    round-trips against anything smart."""

    image: str
    head: str
    generation: int = 0          # bumped per publish; detects staleness
    entries: List[BundleEntry] = field(default_factory=list)

    def entry(self, from_tag: str, to_tag: str) -> Optional[BundleEntry]:
        for e in self.entries:
            if e.from_tag == from_tag and e.to_tag == to_tag:
                return e
        return None


def _index_body(index: BundleIndex) -> dict:
    return {"version": INDEX_VERSION, "image": index.image,
            "head": index.head, "generation": int(index.generation),
            "entries": [e.to_json() for e in index.entries]}


def _index_sig(body: dict, key: bytes) -> str:
    return hmac.new(key, dumps(body).encode(), hashlib.sha256).hexdigest()


def encode_index(index: BundleIndex, key: bytes = b"") -> bytes:
    """Serialize + sign a bundle index. The signature is HMAC-SHA256
    over the canonical body JSON: with a shared ``key`` it proves
    authenticity, with the default empty key it is still a keyed-hash
    integrity check that catches truncation and bit-rot (a reader with
    any key rejects a tampered body either way)."""
    body = _index_body(index)
    return dumps({"body": body, "sig": _index_sig(body, key)}).encode()


def decode_index(data: bytes, key: bytes = b"") -> BundleIndex:
    """Parse + verify a signed bundle index; ``DeltaFormatError`` on any
    structural or signature failure — an unusable index, never a wrong
    plan."""
    try:
        doc = json.loads(data)
        body, sig = doc["body"], doc["sig"]
    except (ValueError, TypeError, KeyError) as exc:
        raise DeltaFormatError(f"malformed bundle index: {exc}") from exc
    if not hmac.compare_digest(_index_sig(body, key), str(sig)):
        raise DeltaFormatError("bundle index signature mismatch")
    if body.get("version") != INDEX_VERSION:
        raise DeltaFormatError(
            f"unsupported index version {body.get('version')!r}")
    try:
        return BundleIndex(
            image=str(body["image"]), head=str(body["head"]),
            generation=int(body["generation"]),
            entries=[BundleEntry.from_json(d) for d in body["entries"]])
    except (ValueError, TypeError, KeyError) as exc:
        raise DeltaFormatError(f"malformed bundle index body: {exc}") from exc


def plan_bundle_chain(index: BundleIndex, held_tags: Iterable[str],
                      head: Optional[str] = None,
                      skip: Iterable[Tuple[str, str]] = ()
                      ) -> Optional[List[BundleEntry]]:
    """Cheapest chain of published bundles carrying a store that holds
    ``held_tags`` to ``head`` (default: the index head), by ADVERTISED
    byte cost — Dijkstra over the index's (from, to) edges, where every
    held tag (and the empty tag, reaching full bundles) is a zero-cost
    source. A single squashed bundle, a k-hop chain and a full pull all
    compete on equal footing; ties break deterministically toward fewer
    hops, then entry order.

    ``skip`` removes (from, to) edges already found unusable (fetch
    failed, hash mismatch, pruned on the far side) so a caller can
    replan mid-pull without them. Tags in the index that the follower
    pruned locally simply never become sources; entries whose bundles
    vanished remotely surface as fetch failures and come back through
    ``skip`` — either way the planner skips unusable chains instead of
    raising. Returns ``[]`` when ``head`` is already held, None when no
    chain reaches it."""
    import heapq

    head = head if head is not None else index.head
    held: Set[str] = set(held_tags)
    if head in held:
        return []
    skipped = set(skip)
    edges: Dict[str, List[Tuple[int, BundleEntry]]] = {}
    for order, e in enumerate(index.entries):
        if (e.from_tag, e.to_tag) in skipped:
            continue
        edges.setdefault(e.from_tag, []).append((order, e))
    # dist: tag -> (bytes, hops); prev: tag -> (entry, source_tag)
    dist: Dict[str, Tuple[int, int]] = {}
    prev: Dict[str, Tuple[BundleEntry, str]] = {}
    heap: List[Tuple[int, int, int, str]] = []
    for order, src in enumerate(sorted(held) + [""]):
        dist[src] = (0, 0)
        heapq.heappush(heap, (0, 0, order, src))
    seq = len(dist)
    while heap:
        cost, hops, _, tag = heapq.heappop(heap)
        if (cost, hops) > dist.get(tag, (cost, hops)):
            continue            # stale heap entry
        if tag == head:
            chain: List[BundleEntry] = []
            while tag in prev:
                entry, tag = prev[tag]
                chain.append(entry)
            chain.reverse()
            return chain
        for order, e in edges.get(tag, ()):
            cand = (cost + max(int(e.size), 0), hops + 1)
            if cand < dist.get(e.to_tag, (float("inf"), 0)):
                dist[e.to_tag] = cand
                prev[e.to_tag] = (e, tag)
                seq += 1
                heapq.heappush(heap, (*cand, seq, e.to_tag))
    return None
