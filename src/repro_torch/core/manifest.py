"""Image / layer metadata — the Docker ``manifest.json`` + ``config.json`` split
(torch port of ``repro/core/manifest.py``; the JSON is byte-identical).

Faithful structure (paper Table III-A):

* ``Manifest``  — config pointer, repo tag, ordered list of layer pointers.
* ``ImageConfig`` — per-layer checksum + instruction trace + version: the
  "lock". Integrity verification recomputes each layer's content checksum
  from its chunk hashes and compares against the config — so an in-place
  content edit *without* re-keying the config fails verification, exactly
  the property the paper's "checksum bypass" (C3) must defeat by updating
  both the key and the lock.
* ``LayerDescriptor`` — id (permanent UUID), version, instruction,
  content checksum (over chunk hashes), chain checksum (hash chain with the
  parent — what makes fall-through structural), tensor records, empty flag.
"""
from __future__ import annotations

import json
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .chunker import TensorRecord, sha256_hex


def new_uuid() -> str:
    return uuid.uuid4().hex


@dataclass
class Instruction:
    op: str                     # FROM | COPY | RUN | ENV | CMD | LABEL
    arg: str                    # payload key or literal
    kind: str                   # "content" | "config"
    derives_from: List[str] = field(default_factory=list)
    # ^ semantic dependencies (payload keys of earlier content layers this
    # derivation actually reads). Docker ignores this — it falls through on
    # *positional* order; injection honors it (the paper's scenario-4 rule:
    # a compile layer must be re-run when its source layer is injected).

    @property
    def text(self) -> str:
        return f"{self.op} {self.arg}"

    def to_json(self) -> dict:
        return {"op": self.op, "arg": self.arg, "kind": self.kind,
                "derives_from": self.derives_from}

    @staticmethod
    def from_json(d: dict) -> "Instruction":
        return Instruction(d["op"], d["arg"], d["kind"],
                           list(d.get("derives_from", [])))


def content_checksum(records: Sequence[TensorRecord]) -> str:
    """Layer content checksum = sha256 over the ordered chunk-hash list.

    O(#chunks), not O(bytes): after injection only the changed chunks were
    re-hashed; the layer checksum recompute is metadata-cheap. This is the
    "compute the checksum of the new layer" step of C3.
    """
    h = "|".join(f"{r.name}:{','.join(r.chunks)}" for r in records)
    return sha256_hex(h.encode())


def chain_checksum(parent_chain: Optional[str], own_content: str,
                   instruction_text: str) -> str:
    """Docker-style hash chain: layer identity commits to everything above it.

    This is what makes fall-through *structural*: change layer k's content
    and every later chain checksum changes, so a rebuilder that keys caches
    on chain checksums must rebuild k+1..N.
    """
    return sha256_hex(f"{parent_chain or ''}+{own_content}+{instruction_text}".encode())


def injection_history_entry(per_layer: Dict[str, Dict[str, int]],
                            total_edits: int,
                            delta: Optional[dict] = None) -> dict:
    """ImageConfig history record for ONE batched injection commit.

    ``per_layer`` mirrors ``BuildReport.per_layer`` (keyed by the source
    image's layer ids), so the image history itself attributes which layer
    cost what in the batch — the audit trail for the multi-layer
    transactional unit.

    ``delta`` is the commit's replication record (see core.delta): the
    base tag, the old->new layer maps split by how each layer changed
    (injected / rederived / rekeyed) and the chunk ids written by this
    commit — what ``history_delta_chain`` and ``registry.squash_deltas``
    compose without re-diffing the stores."""
    entry = {"instruction": "INJECT", "edits": int(total_edits),
             "per_layer": {lid: dict(entry)
                           for lid, entry in per_layer.items()}}
    if delta is not None:
        entry["delta"] = delta
    return entry


def history_delta_chain(config: "ImageConfig", name: str,
                        from_tag: str) -> Optional[List[dict]]:
    """The ordered per-commit delta records carrying ``name:from_tag`` to
    the revision this config locks — the raw material
    ``registry.squash_deltas`` composes into one static bundle.

    Every batched injection appends a self-describing ``delta`` record
    (``injection_history_entry(delta=...)``) to the base's cumulative
    history, so the lineage from ``from_tag`` is exactly the history
    suffix starting at the LAST entry whose ``delta["base"]`` names
    ``from_tag`` (later commits re-based on the same tag supersede
    earlier branches that cannot lead here). Records carry only their
    BASE tag; each suffix entry's base is the implied result of its
    predecessor, which is what makes the suffix contiguous by
    construction. Returns None when the chain cannot be recovered —
    ``from_tag`` fell off the capped history, a non-injection commit
    (full rebuild, structure change) sits in the span, or a record in
    the span has no delta — and the caller must fall back to a
    store-level re-diff (``registry.diff_manifests``)."""
    start = None
    for i, entry in enumerate(config.history):
        d = entry.get("delta") or {}
        base = list(d.get("base") or ())
        if len(base) >= 2 and base[0] == name and base[1] == from_tag:
            start = i
    if start is None:
        return None
    chain: List[dict] = []
    for entry in config.history[start:]:
        d = entry.get("delta")
        base = list((d or {}).get("base") or ())
        if not d or len(base) < 2 or base[0] != name:
            return None
        chain.append(d)
    return chain


@dataclass
class LayerDescriptor:
    layer_id: str               # unique per revision (descriptor identity —
                                # crash safety: a rebuild NEVER overwrites
                                # the previous revision's descriptor)
    version: int
    instruction: Instruction
    checksum: str               # content checksum (over chunk hashes)
    chain: str                  # chain checksum (parent-linked)
    records: List[TensorRecord] = field(default_factory=list)
    empty: bool = False         # config layers carry no content
    family: str = ""            # the paper's "permanent UUID": stable
                                # across revisions of the same layer

    def __post_init__(self):
        if not self.family:
            self.family = self.layer_id

    def to_json(self) -> dict:
        return {
            "id": self.layer_id,
            "family": self.family,
            "version": self.version,
            "instruction": self.instruction.to_json(),
            "layer-checksum": self.checksum,
            "chain-checksum": self.chain,
            "isEmptyLayer": self.empty,
            "tensors": [r.to_json() for r in self.records],
        }

    @staticmethod
    def from_json(d: dict) -> "LayerDescriptor":
        return LayerDescriptor(
            layer_id=d["id"],
            version=int(d["version"]),
            instruction=Instruction.from_json(d["instruction"]),
            checksum=d["layer-checksum"],
            chain=d["chain-checksum"],
            records=[TensorRecord.from_json(r) for r in d.get("tensors", [])],
            empty=bool(d.get("isEmptyLayer", False)),
            family=d.get("family", d["id"]),
        )

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self.records)


@dataclass
class Manifest:
    """The "key": which layers, in which order, make this image."""

    name: str
    tag: str
    layer_ids: List[str]
    config_id: str

    def to_json(self) -> dict:
        return {"RepoTags": [f"{self.name}:{self.tag}"],
                "Layers": list(self.layer_ids),
                "Config": self.config_id}

    @staticmethod
    def from_json(d: dict) -> "Manifest":
        name, tag = d["RepoTags"][0].split(":", 1)
        return Manifest(name=name, tag=tag, layer_ids=list(d["Layers"]),
                        config_id=d["Config"])


@dataclass
class ImageConfig:
    """The "lock": per-layer checksums + build history."""

    config_id: str
    arch: str
    version: int
    layer_checksums: Dict[str, str]      # layer_id -> content checksum
    layer_chains: Dict[str, str]         # layer_id -> chain checksum
    history: List[dict] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "id": self.config_id,
            "arch": self.arch,
            "version": self.version,
            "layer-checksums": dict(self.layer_checksums),
            "chain-checksums": dict(self.layer_chains),
            "history": list(self.history),
        }

    @staticmethod
    def from_json(d: dict) -> "ImageConfig":
        return ImageConfig(
            config_id=d["id"],
            arch=d["arch"],
            version=int(d["version"]),
            layer_checksums=dict(d["layer-checksums"]),
            layer_chains=dict(d["chain-checksums"]),
            history=list(d.get("history", [])),
        )


def dumps(obj: dict) -> str:
    return json.dumps(obj, indent=1, sort_keys=True)
