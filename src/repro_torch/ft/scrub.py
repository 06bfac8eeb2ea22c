"""Background scrub — the detection half of the self-healing loop (torch
port of ``repro/ft/scrub.py``; reports and the cursor file are the JAX
package's, byte for byte).

The paper's injection method bypasses Docker's checksum pipeline, which
makes content-addressed integrity the *only* line between a fast rebuild
and silently serving corrupt weights. The registry hardens the
*in-flight* path (every wire byte re-hashed on receipt); this module
closes the *at-rest* gap: bit-rot, torn writes that slipped past orphan
adoption, a bad disk on one relay tier.

``LayerStore.scrub()`` (core/store.py) performs the walk; this module owns
the structured result model and the persisted cursor so the walk is

* **incremental** — ``max_bytes``/``max_items`` budgets bound one slice,
* **resumable** — the cursor (``<root>/scrub.cursor.json``) records the
  next blob shard, so a fleet-scale store is scrubbed across many slices
  without ever re-hashing a shard twice per pass,
* **complete** — metadata (layer checksums, config locks, chain re-key
  links) is re-verified at the start of every pass; the 256 blob shards
  are re-hashed against their content addresses across the slices.

A ``ScrubReport`` separates *corruption* (``corrupt_blob``,
``missing_blob``, ``layer_*``, ``chain_mismatch`` — anything that breaks
a committed image) from *debris* (``orphan_blob``/``orphan_layer`` — an
unreferenced leftover of a crashed push: ugly, never load-bearing).
``repair_image`` (core/registry.py) consumes the corruption findings and
heals them from any peer holding a good copy.

CLI::

    PYTHONPATH=src python -m repro_torch.ft.scrub --root /path/to/store
    PYTHONPATH=src python -m repro_torch.ft.scrub --soak [--slice-bytes N]

``--soak`` is the scheduled-CI entry: it builds a multitenant store (a
base image plus tenant fine-tunes replicated across stores, the
BENCH_multitenant topology in miniature), scrubs every store full-pass
AND sliced, fails on any finding, then proves the detector against
itself — seeded at-rest bit-flips (``ft.faults.inject_bitrot``) must be
detected 100% with exact attribution.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

#: blob payloads shard under ``blobs/sha256/<h[:2]>/`` — 256 buckets; the
#: scrub cursor is the index of the next un-scrubbed shard of this pass.
N_SHARDS = 256

CURSOR_FILE = "scrub.cursor.json"

#: finding kinds that break a committed image (repair_image's input);
#: everything else ("orphan_*") is crash debris awaiting gc.
CORRUPTION_KINDS = (
    "corrupt_blob", "missing_blob", "layer_checksum_mismatch",
    "layer_unreadable", "missing_layer", "config_lock_mismatch",
    "chain_mismatch", "manifest_unreadable",
)


@dataclass
class ScrubFinding:
    """One integrity problem, attributed as precisely as the walk can.

    ``kind`` is one of ``CORRUPTION_KINDS`` or ``orphan_blob`` /
    ``orphan_layer``. ``image``/``tag``/``layer_id`` locate the first
    committed reference the walk found (empty for orphans — nothing
    committed reaches them). ``blob`` is the chunk's content address when
    the finding is blob-scoped.
    """

    kind: str
    detail: str = ""
    image: str = ""
    tag: str = ""
    layer_id: str = ""
    blob: str = ""

    @property
    def is_corruption(self) -> bool:
        return self.kind in CORRUPTION_KINDS


@dataclass
class ScrubReport:
    """Structured result of one scrub slice (or a full pass).

    ``complete`` is True when this slice finished the pass: every blob
    shard has been re-hashed since the cursor was last reset and the
    metadata walk ran clean start-to-end. Counters cover THIS slice only;
    findings likewise — callers accumulating a sliced pass union them.
    """

    findings: List[ScrubFinding] = field(default_factory=list)
    blobs_scanned: int = 0
    bytes_scanned: int = 0
    layers_scanned: int = 0
    images_scanned: int = 0
    shards_scanned: int = 0
    complete: bool = False
    next_shard: int = 0          # cursor after this slice (0 = pass done)
    wall_s: float = 0.0

    @property
    def corruptions(self) -> List[ScrubFinding]:
        """Findings that break a committed image — repair_image's input."""
        return [f for f in self.findings if f.is_corruption]

    @property
    def orphans(self) -> List[ScrubFinding]:
        return [f for f in self.findings if not f.is_corruption]

    @property
    def corrupt_blob_hashes(self) -> List[str]:
        """Content addresses of committed blobs that failed re-hash or
        vanished — deduplicated, sorted."""
        return sorted({f.blob for f in self.findings
                       if f.kind in ("corrupt_blob", "missing_blob")
                       and f.blob})

    @property
    def clean(self) -> bool:
        return not self.findings

    def merge(self, other: "ScrubReport") -> None:
        """Accumulate a later slice of the same pass into this report."""
        self.findings.extend(other.findings)
        self.blobs_scanned += other.blobs_scanned
        self.bytes_scanned += other.bytes_scanned
        self.layers_scanned += other.layers_scanned
        self.images_scanned += other.images_scanned
        self.shards_scanned += other.shards_scanned
        self.complete = other.complete
        self.next_shard = other.next_shard
        self.wall_s += other.wall_s

    def summary(self) -> str:
        state = "complete" if self.complete else \
            f"paused@shard={self.next_shard}"
        return (f"scrub {state}: {self.blobs_scanned} blobs "
                f"({self.bytes_scanned} B) / {self.layers_scanned} layers "
                f"/ {self.images_scanned} images, "
                f"{len(self.corruptions)} corruptions, "
                f"{len(self.orphans)} orphans")


# ------------------------------------------------------------------ cursor
def cursor_path(root: str) -> str:
    return os.path.join(root, CURSOR_FILE)


def load_cursor(root: str) -> int:
    """Next shard of the in-progress pass (0 = start a fresh pass). A
    missing or unreadable cursor restarts the pass — over-scrubbing is
    always safe."""
    try:
        with open(cursor_path(root), "rb") as f:
            shard = int(json.load(f).get("next_shard", 0))
    except (OSError, ValueError):
        return 0
    return shard if 0 <= shard < N_SHARDS else 0


def save_cursor(root: str, next_shard: int) -> None:
    """Persist the pass position (atomic rename; no fsync — losing the
    cursor only costs re-scrubbed shards, never correctness)."""
    tmp = f"{cursor_path(root)}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(json.dumps({"next_shard": int(next_shard)}).encode())
    os.replace(tmp, cursor_path(root))


def clear_cursor(root: str) -> None:
    try:
        os.remove(cursor_path(root))
    except OSError:
        pass


# --------------------------------------------------------------- CLI / soak
def _build_soak_store(base_dir: str, tenants: int = 3):
    """A miniature of the BENCH_multitenant topology: one base image plus
    ``tenants`` fine-tunes sharing its blob universe, consolidated onto a
    remote store — the namespace the scheduled scrub-soak walks."""
    import numpy as np
    import torch

    from ..core import LayerStore, push_delta
    from ..core.manifest import Instruction

    rng = np.random.default_rng(7)
    src = LayerStore(os.path.join(base_dir, "src"), chunk_bytes=4096)
    backbone = {f"b{i}": torch.from_numpy(
        rng.standard_normal(2048).astype(np.float32)) for i in range(6)}
    ins = [Instruction("FROM", "scratch", "config"),
           Instruction("COPY", "backbone", "content"),
           Instruction("CMD", "serve", "config")]
    src.build_image("base", "v1", ins,
                    {"backbone": lambda: backbone})
    for t in range(tenants):
        adapter = dict(backbone)
        adapter[f"b{t % 6}"] = backbone[f"b{t % 6}"] + float(t + 1)
        src.build_image(f"tenant-{t}", "v1", ins,
                        {"backbone": lambda a=adapter: a})
    remote = LayerStore(os.path.join(base_dir, "remote"), chunk_bytes=4096)
    push_delta(src, remote, "base", "v1")
    for t in range(tenants):
        push_delta(src, remote, f"tenant-{t}", "v1")
    return src, remote


def _soak(slice_bytes: Optional[int],
          seeds: Optional[Iterable[int]] = None) -> int:
    import shutil
    import tempfile

    from ..core import LayerStore
    from .faults import inject_bitrot

    base = tempfile.mkdtemp(prefix="scrub_soak_")
    try:
        src, remote = _build_soak_store(base)
        failures = 0
        for store in (src, remote):
            # full pass in one slice
            rep = store.scrub()
            print(f"{store.root}: {rep.summary()}")
            if not (rep.complete and rep.clean):
                failures += 1
            # the same pass sliced under a byte budget must find the same
            # nothing and terminate (a complete pass resets the cursor)
            sliced = ScrubReport()
            for _ in range(N_SHARDS + 4):
                part = store.scrub(max_bytes=slice_bytes or 64 << 10)
                sliced.merge(part)
                if part.complete:
                    break
            print(f"{store.root}: sliced -> {sliced.summary()}")
            if not (sliced.complete and sliced.clean):
                failures += 1
        # detector self-proof: seeded at-rest flips must be found, all of
        # them, on a scratch copy of the remote — one round per seed (CI
        # shards the seed range exactly like the chaos soak)
        for seed in (seeds if seeds is not None else [11]):
            victim_root = os.path.join(base, f"victim-{seed}")
            shutil.copytree(remote.root, victim_root)
            victim = LayerStore(victim_root, chunk_bytes=4096)
            flips = inject_bitrot(victim_root, seed=seed, count=3)
            rep = victim.scrub()
            detected = set(rep.corrupt_blob_hashes)
            want = {h for h, _ in flips}
            print(f"bitrot self-proof (seed {seed}): injected {len(want)}, "
                  f"detected {len(detected & want)}")
            if detected & want != want:
                failures += 1
            shutil.rmtree(victim_root, ignore_errors=True)
        if failures:
            print(f"FAIL: {failures} scrub-soak failures")
            return 1
        print("scrub-soak: all stores clean, detector catches 100% of "
              "seeded bit-rot")
        return 0
    finally:
        shutil.rmtree(base, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="scrub a LayerStore (or run the CI scrub-soak)")
    ap.add_argument("--root", help="store root to scrub")
    ap.add_argument("--soak", action="store_true",
                    help="build the multitenant soak store and scrub it, "
                         "failing on any finding")
    ap.add_argument("--slice-bytes", type=int, default=None,
                    help="re-hash budget per slice (default: one pass)")
    ap.add_argument("--seeds", default=None,
                    help="bitrot self-proof seeds for --soak: 'N', "
                         "'A:B', 'A:B:S', or the CI shard shorthand "
                         "'I::S' (see ft.chaos.parse_seeds)")
    ap.add_argument("--reset", action="store_true",
                    help="discard the persisted cursor first")
    args = ap.parse_args(argv)

    if args.soak:
        from .chaos import parse_seeds
        return _soak(args.slice_bytes,
                     seeds=None if args.seeds is None
                     else parse_seeds(args.seeds))
    if not args.root:
        ap.error("--root or --soak required")
    from ..core import LayerStore

    store = LayerStore(args.root)
    if args.reset:
        clear_cursor(args.root)
    total = ScrubReport()
    while True:
        rep = store.scrub(max_bytes=args.slice_bytes)
        total.merge(rep)
        if rep.complete or args.slice_bytes is None:
            break
    print(total.summary())
    for f in total.findings:
        where = ":".join(p for p in (f.image, f.tag, f.layer_id[:12])
                         if p)
        print(f"  {f.kind:24s} {where} {f.blob[:12]} {f.detail}")
    return 1 if total.findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
