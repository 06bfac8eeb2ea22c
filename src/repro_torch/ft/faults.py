"""Deterministic fault injection — the chaos-testing substrate (torch port
of ``repro/ft/faults.py``, with the same fault-point names).

The port's injector is its own: a plan installed here fires only at the
port's fault points, never at the JAX package's, and the reverse.

Production code is threaded with **named fault points**: zero-cost no-ops
until a ``FaultInjector`` is installed, at which point any of them can
drop, corrupt, delay or crash — the four failure modes a replication
topology must survive. The replication stack (``core.store.LayerStore``,
``core.registry.DeltaReceiver``/``RelayNode``/``replicate_fanout``,
``serve.CheckpointFollower``) calls ``fault_point(name, key=..., data=...)``
at every seam; the tests drive seeded fault plans through them and assert
convergence.

Determinism is the whole point: whether a given hit fires is a pure
function of ``(seed, point, key, nth-hit-of-that-key)`` — a SHA-256-derived
uniform draw, NOT a sequential RNG — so the decision is reproducible even
when hits arrive on pool threads in nondeterministic order. A failing chaos
seed printed by CI replays bit-identically on a laptop.

Fault points currently wired (point / key):

    store.write_blob      <store.root>:<blob hash>   (disk-write corruption)
    store.read_blob       <store.root>:<blob hash>   (bad-sector read)
    store.commit          <store.root>               (death at the rename)
    wire.negotiate        <dst.root>                 (lost exchange)
    wire.probe_blobs      <dst.root>
    wire.receive_layer    <dst.root>:<layer id>
    wire.receive_blob     <dst.root>:<blob hash>     (corrupt transfer)
    wire.commit           <dst.root>                 (death pre-rename)
    relay.fan             <relay.root>               (relay dies at re-fan)
    follower.pull         <local.root>:<image>:<tag> (hung/failed poll)
    bundle.publish        <registry root>:<image>:<from>-><to>  and
                          <registry root>:<image>:index
                          (passive-registry write: torn/corrupt bundle
                          file, stale or corrupt index)
    bundle.fetch          same keys as bundle.publish
                          (passive-registry read: truncated bundle,
                          unreachable index)

``FaultInjected`` subclasses ``ConnectionError`` so a dropped wire op looks
exactly like a flaky network to the caller; ``CrashInjected`` simulates
process death — the run aborts mid-flight and the next attempt plays the
part of the restarted process (crash-atomicity means it converges).

The fifth mode, ``bitrot``, models silent at-rest corruption (a decaying
disk, not a flaky wire). At a fault point it behaves like ``corrupt`` —
the crucial difference is WHERE it is aimed: fired at ``store.write_blob``
the flipped byte is *persisted*, committing a corrupt blob that no
in-flight check will ever re-read. For corruption of blobs already at
rest there is ``inject_bitrot(root, seed, ...)``, which flips one
deterministic byte in each selected committed blob file in place.
Healing is ``repair_image`` (core/registry.py); the follower's verify
gate (``serve.CheckpointFollower``) is what detects it on the serving
path.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class FaultInjected(ConnectionError):
    """A dropped operation (transient, retryable — like a reset socket)."""


class CrashInjected(RuntimeError):
    """Simulated process death at a fault point. Handlers treat it like
    SIGKILL: whatever was in flight is abandoned (possibly torn, never
    committed) and a fresh attempt must converge from the debris."""


@dataclass
class FaultSpec:
    """One rule of a fault plan.

    ``point`` names the fault point exactly, or a prefix ending in ``*``
    (``"wire.*"``). ``match`` is a substring the hit's key must contain —
    target one store by its root path, one blob by its hash. ``prob`` is
    the per-hit fire probability (decided deterministically, see module
    docstring). ``skip`` lets the first N matching hits of each key pass
    untouched; ``times`` caps fires per key (None = every time). Counters
    are per ``(spec, point, key)`` so concurrency cannot reorder them.
    """

    point: str
    mode: str         # "drop" | "corrupt" | "delay" | "crash" | "bitrot"
    prob: float = 1.0
    match: str = ""
    skip: int = 0
    times: Optional[int] = 1
    delay_s: float = 0.01

    def __post_init__(self):
        if self.mode not in ("drop", "corrupt", "delay", "crash",
                             "bitrot"):
            raise ValueError(f"unknown fault mode {self.mode!r}")

    def matches(self, point: str, key: str) -> bool:
        if self.point.endswith("*"):
            if not point.startswith(self.point[:-1]):
                return False
        elif point != self.point:
            return False
        return self.match in key


@dataclass
class FaultEvent:
    """One fired fault, recorded for assertions."""

    point: str
    key: str
    mode: str
    hit: int                        # nth hit of (point, key) when it fired


def _unit(seed: int, point: str, key: str, n: int) -> float:
    """Deterministic uniform [0, 1) from the hit's identity — stable under
    any thread interleaving (no shared RNG stream)."""
    h = hashlib.sha256(f"{seed}:{point}:{key}:{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultInjector:
    """A seeded fault plan. Install with ``with injector.active():`` (or
    the module-level ``inject(...)`` convenience); every ``fault_point``
    call in the process consults it while installed. Thread-safe: hit
    counters and the event log are lock-guarded, fire decisions are
    order-independent (hash-based)."""

    def __init__(self, seed: int = 0, specs: Tuple[FaultSpec, ...] = ()):
        self.seed = seed
        self.specs: List[FaultSpec] = list(specs)
        self.log: List[FaultEvent] = []
        self._hits: Dict[Tuple[int, str, str], int] = {}
        self._lock = threading.Lock()

    def fired(self, point: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for e in self.log
                       if point is None or e.point == point)

    def hit(self, point: str, key: str, data: Optional[bytes]
            ) -> Optional[bytes]:
        """Evaluate one fault-point hit. First matching spec that fires
        wins. Returns (possibly corrupted) ``data``; raises on drop/crash;
        sleeps on delay."""
        for si, spec in enumerate(self.specs):
            if not spec.matches(point, key):
                continue
            with self._lock:
                n = self._hits.get((si, point, key), 0)
                self._hits[(si, point, key)] = n + 1
            if n < spec.skip:
                continue
            fires_before = n - spec.skip
            if spec.times is not None and fires_before >= spec.times:
                continue
            if spec.prob < 1.0 and \
                    _unit(self.seed, point, key, n) >= spec.prob:
                continue
            with self._lock:
                self.log.append(FaultEvent(point, key, spec.mode, n))
            if spec.mode == "drop":
                raise FaultInjected(
                    f"injected drop at {point} ({key[-24:]})")
            if spec.mode == "crash":
                raise CrashInjected(
                    f"injected crash at {point} ({key[-24:]})")
            if spec.mode == "delay":
                time.sleep(spec.delay_s)
                return data
            # corrupt/bitrot: flip one deterministic byte; at a data-less
            # point a corruption manifests as a drop (nothing to mangle).
            # The two modes differ only in aim (see module docstring):
            # "bitrot" targets write/at-rest points so the flip PERSISTS.
            if data is None or len(data) == 0:
                raise FaultInjected(
                    f"injected corrupt-drop at {point} ({key[-24:]})")
            pos = int(_unit(self.seed, point, key, n) * len(data)) \
                % len(data)
            out = bytearray(data)
            out[pos] ^= 0xFF
            return bytes(out)
        return data

    @contextlib.contextmanager
    def active(self):
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a FaultInjector is already installed")
            _ACTIVE = self
        try:
            yield self
        finally:
            with _INSTALL_LOCK:
                _ACTIVE = None


_ACTIVE: Optional[FaultInjector] = None
_INSTALL_LOCK = threading.Lock()


def fault_point(point: str, key: str = "",
                data: Optional[bytes] = None) -> Optional[bytes]:
    """The hook production code calls. A no-op (returns ``data``
    unchanged) unless an injector is installed — one attribute load on the
    hot path."""
    inj = _ACTIVE
    if inj is None:
        return data
    return inj.hit(point, key, data)


def inject(seed: int = 0, *specs: FaultSpec):
    """``with inject(seed, FaultSpec(...), ...) as inj:`` convenience."""
    return FaultInjector(seed, tuple(specs)).active()


def inject_bitrot(root: str, seed: int, count: int = 1,
                  candidates: Optional[List[str]] = None
                  ) -> List[Tuple[str, int]]:
    """Flip one byte in each of ``count`` at-rest blob payloads under
    ``<root>/blobs/sha256`` — the silent-disk-decay fault the scrub/repair
    loop must detect and heal.

    Victim selection and flip position are pure functions of
    ``(seed, blob hash)`` (the same SHA-derived draw as the fault points),
    so a chaos cell replays bit-identically. ``candidates`` restricts the
    victim pool to those hashes (e.g. one image's chunk set, so the cell
    knows which image to repair); default is every blob on disk. Flips are
    applied in place — no injector needs to be installed. Returns
    ``[(hash, flipped_offset), ...]`` for the detection assertions.
    """
    shard_root = os.path.join(root, "blobs", "sha256")
    if candidates is None:
        pool = []
        for sub in sorted(os.listdir(shard_root)):
            d = os.path.join(shard_root, sub)
            if os.path.isdir(d):
                pool.extend(sorted(os.listdir(d)))
    else:
        pool = sorted(set(candidates))
    pool = [h for h in pool
            if os.path.exists(os.path.join(shard_root, h[:2], h))]
    if not pool:
        return []
    ranked = sorted(pool, key=lambda h: _unit(seed, "bitrot.pick", h, 0))
    flipped: List[Tuple[str, int]] = []
    for h in ranked[:max(count, 0)]:
        path = os.path.join(shard_root, h[:2], h)
        size = os.path.getsize(path)
        if size == 0:
            continue
        pos = int(_unit(seed, "bitrot.pos", h, 0) * size) % size
        with open(path, "r+b") as f:
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ 0xFF]))
        flipped.append((h, pos))
    return flipped
