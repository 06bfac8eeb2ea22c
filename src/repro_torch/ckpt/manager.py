"""CheckpointManager — training state as layered, content-addressed images
(torch port of ``repro/ckpt/manager.py``: saves, synchronous or on one
background writer, retention, restore, tenants sharing one store, and
delta replication).

A checkpoint is an image whose layers mirror a Dockerfile:

    FROM <arch>                      (config layer, empty)
    COPY params/embed                (content layer)
    COPY params/blocks               (content layer — the big one)
    COPY params/head                 (content layer)
    RUN  opt_state                   (content layer)
    ENV  meta step=<n>               (config layer)

Leaf paths, layer order and dtype strings equal the JAX manager's, so each
package restores the other's checkpoints bit for bit.

* The first save is the Docker-faithful full build (``build_image``).
* Later saves with ``incremental`` are the code-injection path: with
  ``use_fingerprints``, ONE device fingerprint pass over the whole tree
  (``fingerprint_tree_packed``: one kernel launch on the card, one
  (total_chunks, 2) table over D2H, ``BuildReport.bytes_d2h``), then only
  the changed chunk ranges are copied to the host and SHA-256'd, and all
  changed layers go through ONE ``inject_image_multi`` transaction.
  ``packed_fingerprints=False`` keeps the per-leaf baseline
  (``fingerprint_tree``: one launch and one D2H copy per leaf).

Leaves stay on their device until a chunk range is actually needed.

With ``async_write`` the save runs on a one-worker pool and ``wait()``
joins it. The port's optimizer updates its state in place, so ``save``
first copies every leaf (on its device, before it returns): the writer
then reads the state of the step it was given, whatever the trainer does
next. After each commit, retention (``prune_steps``) drops step tags
beyond the ``keep`` newest (a leased tag is skipped) and sweeps the store.
With ``registry=`` (a ``PassiveRegistry`` or a directory) each commit is
then published as bundles (the head in full, plus one squashed bundle
per ``publish_spans`` entry) under a signed index, for followers that
pull without a live peer.

Trees with DTensor leaves (a train step on a mesh) save as their full
tensors: every rank takes part in the gather, ONLY rank 0 writes the
store (and runs the fingerprint kernel on its gathered leaves), and a
barrier follows, so that no rank reads a half-written commit (with
``async_write``, in ``wait()``, which every rank calls at the same points).
``ckpt.reshard.reshard_restore`` lays a restore onto any mesh.

Several managers may share ONE store (``store=``), each under its own
``image=``; ``base_image=`` forks a tenant's first save from another image
of that store, and ``replicate()`` ships a checkpoint to replica stores as
a delta.
"""
from __future__ import annotations

import re
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core import (BuildReport, Instruction, LayerStore, PassiveRegistry,
                    RelayNode, diff_image, fingerprint_tree,
                    fingerprint_tree_packed, inject_image_multi, push_delta,
                    replicate_fanout)
from ..device import resolve_device
from ..ft.faults import CrashInjected


def flatten_tree(tree, prefix="") -> Dict[str, torch.Tensor]:
    """nested dict -> flat {path: tensor} with sorted, '/'-joined keys.
    Tensors are kept as they are (device leaves stay on the device);
    anything else becomes a host tensor."""
    out: Dict[str, torch.Tensor] = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k2 in sorted(t.keys()):
                walk(t[k2], f"{path}/{k2}" if path else k2)
        elif isinstance(t, torch.Tensor):
            out[path] = t
        else:
            out[path] = torch.from_numpy(np.array(t))

    walk(tree, prefix)
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


_STEP_TAG = re.compile(r"step-(\d+)")


def step_of_tag(tag: str) -> Optional[int]:
    """The step number of a canonical ``step-%08d`` tag, None for any other
    tag (user tags never take part in step parsing)."""
    m = _STEP_TAG.fullmatch(tag)
    if not m:
        return None
    n = int(m.group(1))
    return n if tag == f"step-{n:08d}" else None


def latest_step(store: LayerStore, image: str,
                fresh: bool = False) -> Optional[int]:
    """Newest step number among an image's canonical step tags."""
    return max((s for s in (step_of_tag(t)
                            for t in store.list_tags(image, fresh=fresh))
                if s is not None), default=None)


def prune_steps(store: LayerStore, image: str, keep: int) -> bool:
    """Retention and reclamation: drop step tags beyond the ``keep`` newest
    (ordered by step number; tags that are not canonical step tags are
    never candidates), then mark-and-sweep the store so their exclusive
    blobs and layers are deleted. Returns whether anything was removed.
    ``keep <= 0`` keeps everything.

    Tags under an active retention LEASE (a relay pinning the base a
    lagging child's delta still negotiates against — see
    ``LayerStore.acquire_lease``) are skipped, not deleted; the next prune
    after the lease is released or expires reclaims them."""
    if keep <= 0:
        return False
    steps = sorted((s, t) for t in store.list_tags(image)
                   if (s := step_of_tag(t)) is not None)
    removed = False
    for _, t in steps[:-keep]:
        # remove_image refuses leased tags on its own; checking here too
        # keeps the gc() decision honest (a fully-leased prune is a no-op)
        if store.leased(image, t):
            continue
        removed = store.remove_image(image, t) or removed
    if removed:
        store.gc()
    return removed


@dataclass
class CheckpointPolicy:
    every_steps: int = 100
    keep: int = 3
    incremental: bool = True          # the paper's technique (vs baseline)
    use_fingerprints: bool = False    # on-device change detection
    packed_fingerprints: bool = True  # ONE dispatch for the whole tree
                                      # (False = per-leaf dispatch baseline)
    async_write: bool = True
    chunk_bytes: int = 1 << 20
    durability: str = "batch"         # per-chunk fsyncs defer to one
                                      # concurrent flush at the commit
    # passive-registry publish-on-save policy (active only when the
    # manager is given a ``registry=``): after each save, advertise a
    # full head bundle plus one squashed bundle per span, where span k
    # reaches back k COMMITTED step tags.
    publish_spans: Tuple[int, ...] = (1, 4, 8)


class CheckpointManager:
    """See module docstring. ``image=`` names this manager's image (default
    ``"ckpt"``), and several managers may share ONE ``LayerStore`` (pass
    ``store=``; ``root`` is then ignored): the cross-image blob universe,
    where tenant checkpoints dedup against each other and against a shared
    base. ``base_image=("name", "tag")`` forks this manager's FIRST save
    from another image in the same store: the build runs with that image
    as its DLC cache parent, so unchanged layers reuse the base's layer ids
    outright, and ``replicate`` later ships only the adapter delta to
    replicas that already hold the base. Retention (``prune_steps`` and
    the store-wide ``gc()``) is per image but safe across images.
    ``registry=`` is the passive bundle registry to publish into after
    each save (best-effort: an error lands in ``last_publish_error`` and
    never fails the save)."""

    IMAGE = "ckpt"

    def __init__(self, root: str, arch: str,
                 policy: Optional[CheckpointPolicy] = None,
                 image: Optional[str] = None,
                 base_image: Optional[Tuple[str, str]] = None,
                 store: Optional[LayerStore] = None,
                 registry=None):
        self.policy = policy or CheckpointPolicy()
        # a shared store keeps ITS chunking/durability: tenants of one
        # universe must agree on chunk geometry or dedup silently dies
        self.store = store if store is not None else LayerStore(
            root, chunk_bytes=self.policy.chunk_bytes,
            durability=self.policy.durability)
        self.image = image or self.IMAGE
        self.base_image = base_image
        self.arch = arch
        self.registry = registry if registry is None or \
            isinstance(registry, PassiveRegistry) \
            else PassiveRegistry(str(registry))
        if self.registry is not None:
            self.registry.attach_gc(self.store, self.image)
        self.last_publish = None
        self.last_publish_error: Optional[str] = None
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._last_fps: Dict[str, np.ndarray] = {}
        self.last_report: Optional[BuildReport] = None
        self._barrier_due = False      # a sharded save's closing barrier

    # ------------------------------------------------------------ layout
    def _instructions(self) -> List[Instruction]:
        return [
            Instruction("FROM", self.arch, "config"),
            Instruction("COPY", "params/embed", "content"),
            Instruction("COPY", "params/blocks", "content"),
            Instruction("COPY", "params/head", "content"),
            Instruction("RUN", "opt_state", "content",
                        derives_from=[]),   # values evolve, not re-derived
            Instruction("ENV", "meta", "config"),
        ]

    def _payloads(self, params, opt_state, step: int
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
        flat = flatten_tree(params, "params")
        embed = {k: v for k, v in flat.items()
                 if k.startswith("params/embed")}
        blocks = {k: v for k, v in flat.items()
                  if k.startswith("params/blocks")}
        head = {k: v for k, v in flat.items()
                if not k.startswith(("params/embed", "params/blocks"))}
        opt = flatten_tree(opt_state, "opt")
        opt["opt/__step__"] = torch.tensor([step], dtype=torch.int32)
        return {"params/embed": embed, "params/blocks": blocks,
                "params/head": head, "opt_state": opt}

    # -------------------------------------------------------------- save
    def tag_of(self, step: int) -> str:
        return f"step-{step:08d}"

    def latest_step(self) -> Optional[int]:
        return latest_step(self.store, self.image)

    def wait(self) -> Optional[BuildReport]:
        """Join the pending asynchronous save (re-raising its error);
        returns the last save's report."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self.last_report = pending.result()
        if self._barrier_due:
            self._barrier_due = False
            dist.barrier()
        return self.last_report

    def save(self, step: int, params, opt_state) -> BuildReport:
        """Full or incremental save per policy. Synchronous: returns its
        BuildReport. With ``async_write``: copies the state, hands the save
        to the writer and returns an empty BuildReport, as the reference
        does; ``wait()`` gives the real one. With DTensor leaves every rank
        calls it: all gather, rank 0 writes, and the others return an empty
        BuildReport."""
        self.wait()
        payloads = self._payloads(params, opt_state, step)
        if any(isinstance(t, DTensor) for tree in payloads.values()
               for t in tree.values()):
            payloads = {k: {n: t.full_tensor() if isinstance(t, DTensor)
                            else t for n, t in tree.items()}
                        for k, tree in payloads.items()}
            self._barrier_due = True
            if dist.get_rank() != 0:
                if not self.policy.async_write:
                    self.wait()
                return BuildReport()
        if self.policy.incremental and self.latest_step() is not None:
            fn = self._save_incremental
        else:
            fn = self._save_full
        if self.policy.async_write:
            payloads = {k: {n: t.clone() for n, t in tree.items()}
                        for k, tree in payloads.items()}
            self._pending = self._pool.submit(fn, step, payloads)
            return BuildReport()
        report = fn(step, payloads)
        self.last_report = report
        self.wait()                 # a sharded save's barrier
        return report

    def _compute_fps(self, payloads: Dict[str, Dict[str, torch.Tensor]],
                     stats: dict) -> Dict[str, np.ndarray]:
        """Fingerprint every tensor of the checkpoint. Packed mode issues
        ONE kernel launch and one D2H copy for the whole tree; per-leaf
        mode is the launch-per-tensor baseline kept for comparison."""
        union: Dict[str, torch.Tensor] = {}
        for tree in payloads.values():
            union.update(tree)
        if self.policy.packed_fingerprints:
            return fingerprint_tree_packed(union, self.policy.chunk_bytes,
                                           stats=stats)
        fps = fingerprint_tree(union, self.policy.chunk_bytes)
        stats["bytes_d2h"] = stats.get("bytes_d2h", 0) + \
            sum(v.nbytes for v in fps.values())
        stats["device_dispatches"] = stats.get("device_dispatches", 0) + \
            len(fps)
        return fps

    def _save_full(self, step: int,
                   payloads: Dict[str, Dict[str, torch.Tensor]],
                   fps: Optional[Dict[str, np.ndarray]] = None
                   ) -> BuildReport:
        prev = self.latest_step()
        parent = (self.image, self.tag_of(prev)) if prev is not None \
            else self.base_image
        providers = {k: (lambda p=v: p) for k, v in payloads.items()}
        ins = self._instructions()
        ins[-1] = Instruction("ENV", f"meta step={step}", "config")
        _, _, report = self.store.build_image(
            self.image, self.tag_of(step), ins, providers, parent=parent,
            arch=self.arch)
        if self.policy.use_fingerprints:
            # bootstrap the change detector for the NEXT incremental save
            stats: dict = {}
            self._last_fps = fps if fps is not None else \
                self._compute_fps(payloads, stats)
            report.bytes_d2h += stats.get("bytes_d2h", 0)
        self._gc()
        self._publish()
        return report

    def _save_incremental(self, step: int,
                          payloads: Dict[str, Dict[str, torch.Tensor]]
                          ) -> BuildReport:
        """The paper's injection path (C1-C4) as ONE multi-layer batch."""
        prev = self.latest_step()
        manifest, _ = self.store.read_image(self.image, self.tag_of(prev))
        stats: dict = {}
        new_fps: Dict[str, np.ndarray] = {}
        if self.policy.use_fingerprints:
            new_fps = self._compute_fps(payloads, stats)
        layers = [self.store.read_layer(lid) for lid in manifest.layer_ids]
        if self.policy.use_fingerprints:
            diffs = diff_image(layers, payloads,
                               old_fps=self._last_fps, new_fps=new_fps)
        else:
            diffs = diff_image(layers, payloads)
        try:
            _, _, report = inject_image_multi(
                self.store, self.image, self.tag_of(prev),
                self.tag_of(step), diffs,
                providers={k: (lambda p=v: p) for k, v in payloads.items()},
                durability=self.policy.durability)
        except CrashInjected:
            raise           # simulated SIGKILL: the process is gone, it
            # cannot fall back to a full rebuild "after" dying
        except Exception:  # noqa: BLE001
            # structure changed ("compiled" case), or any other failure of
            # the injection -> rebuild fall-back
            report = self._save_full(step, payloads,
                                     fps=new_fps if new_fps else None)
        report.bytes_d2h += stats.get("bytes_d2h", 0)
        if self.policy.use_fingerprints:
            self._last_fps = new_fps or self._last_fps
        self._gc()
        self._publish()
        return report

    def _gc(self) -> None:
        """Retention (``prune_steps``). Runs after the manifest commit, on
        the saving thread, so no batch transaction is open; the store's gc
        spares anything still dirty in one regardless."""
        prune_steps(self.store, self.image, self.policy.keep)

    def _publish(self) -> None:
        """Advertise the just-committed head in the passive bundle
        registry (``policy.publish_spans``): a full bundle plus one
        squashed bundle per span back over the committed step tags.
        Best-effort by contract — a dead object store must never fail a
        save, so every error is swallowed into ``last_publish_error``
        and the next save's publish retries (the index stays
        stale-but-consistent in the meantime, which followers already
        treat as a fall-back signal)."""
        if self.registry is None:
            return
        try:
            steps = sorted(s for t in self.store.list_tags(self.image)
                           if (s := step_of_tag(t)) is not None)
            if not steps:
                return
            froms = [self.tag_of(steps[-1 - span])
                     for span in self.policy.publish_spans
                     if span < len(steps)]
            self.last_publish = self.registry.publish_image(
                self.store, self.image, self.tag_of(steps[-1]),
                from_tags=froms)
            self.last_publish_error = None
        except CrashInjected:
            raise           # the saver process dying is not "a dead
            # object store" — best-effort must not swallow the crash
        except Exception as e:  # noqa: BLE001
            self.last_publish_error = f"{type(e).__name__}: {e}"

    # --------------------------------------------------------- replication
    def replicate(self, remote=None, step: Optional[int] = None,
                  relay=None, source: Optional[str] = None):
        """Ship a checkpoint to serving/registry stores as a DELTA: one
        have-set negotiation + only the chunks a remote is missing cross
        the wire. After an incremental save this is O(changed bytes) —
        call it at the save cadence to keep serving replicas hot.

        ``remote`` is a LayerStore or filesystem path (-> ``push_delta``,
        returns PushStats, failures raise), or a list/tuple of them (->
        ``replicate_fanout``, returns FanoutStats: ONE negotiation round +
        one source read pass for the whole fleet, per-replica failures
        isolated so one sick replica never blocks the rest).

        ``relay`` adds multi-hop tiers (trainer -> M relays -> N edge
        followers each): a dict ``{relay_store_or_path: [children...]}``,
        or a sequence of ``RelayNode``s / ``(store_or_path, children)``
        pairs; children may themselves be any of those shapes, so tiers
        nest. Relays and plain remotes ride the SAME fan-out (one
        negotiation round, one source read pass); each relay re-fans its
        pull to its children — streaming from the in-flight pull with
        ``source="inflight"``, after its own commit with "commit", or each
        node's configured mode when None. Returns FanoutStats whose
        ``replicas[i].children`` nests each relay's downstream outcome."""
        self.wait()
        if remote is None and relay is None:
            raise ValueError("replicate() needs a destination: pass "
                             "remote=, relay=, or both")
        step = step if step is not None else self.latest_step()
        if step is None:
            return None

        def as_store(r):
            # RelayNodes pass through untouched (replicate_fanout accepts
            # receivers directly), so a relay may ride in a remote list
            if isinstance(r, (LayerStore, RelayNode)):
                return r
            return LayerStore(str(r), chunk_bytes=self.policy.chunk_bytes)

        def as_relays(spec):
            # dict {store: children} | sequence of RelayNode /
            # (store, children) pairs — children recurse through the same
            # shapes, so tiers nest in any of them
            out = []
            for item in (spec.items() if isinstance(spec, dict) else spec):
                if isinstance(item, RelayNode):
                    out.append(item)
                    continue
                store, children = item
                if isinstance(children, (str, bytes)):
                    # would be iterated per CHARACTER into junk stores
                    raise TypeError("relay children must be a sequence, "
                                    f"not a bare path: {children!r}")
                kids = []
                for c in children:
                    if isinstance(c, dict):
                        kids.extend(as_relays(c))
                    elif isinstance(c, (tuple, RelayNode)):
                        kids.extend(as_relays([c]))
                    else:
                        kids.append(as_store(c))
                out.append(RelayNode(as_store(store), children=kids))
            return out

        if relay is not None:
            relays = as_relays(relay)
            plain = [] if remote is None else (
                list(remote) if isinstance(remote, (list, tuple)) else [remote])
            return replicate_fanout(
                self.store, [as_store(r) for r in plain] + relays,
                self.image, self.tag_of(step), source=source)
        if isinstance(remote, (list, tuple)):
            # source re-modes RelayNodes the caller put in the list; with
            # none present it would be a silent no-op, so reject it the
            # same way the single-remote branch does
            if source is not None and \
                    not any(isinstance(r, RelayNode) for r in remote):
                raise ValueError("source= only applies to relay "
                                 "topologies; no relay in the remote list")
            return replicate_fanout(self.store, [as_store(r) for r in remote],
                                    self.image, self.tag_of(step),
                                    source=source)
        if source is not None and not isinstance(remote, RelayNode):
            raise ValueError("source= only applies to relay topologies; a "
                             "plain remote has no re-fan to mode")
        if isinstance(remote, RelayNode):
            fan = replicate_fanout(self.store, [remote], self.image,
                                   self.tag_of(step), source=source)
            rep = fan.replicas[0]
            if rep.exception is not None:
                raise rep.exception
            return fan
        return push_delta(self.store, as_store(remote), self.image,
                          self.tag_of(step))

    # ------------------------------------------------------------ restore
    def restore(self, step: Optional[int] = None, device=None
                ) -> Optional[Tuple[Any, Any, int]]:
        """-> (params, opt_state, step) with every tensor on ``device`` (the
        card unless ``device="cpu"`` is asked for), or None when the image
        has no checkpoint. Joins a pending asynchronous save first."""
        device = resolve_device(device)
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        flat = self.store.load_image_payload(self.image, self.tag_of(step))
        flat = {k: v.to(device) for k, v in flat.items()}
        opt_flat = {k[len("opt/"):]: v for k, v in flat.items()
                    if k.startswith("opt/")}
        saved_step = int(opt_flat.pop("__step__")[0])
        params_flat = {k[len("params/"):]: v for k, v in flat.items()
                       if k.startswith("params/")}
        return (unflatten_tree(params_flat), unflatten_tree(opt_flat),
                saved_step)
