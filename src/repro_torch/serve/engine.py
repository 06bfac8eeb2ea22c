"""Batched serving engine: prefill once, decode step by step (torch port of
``Engine`` and ``changed_tensor_paths`` from ``repro/serve/engine.py``).

Decoding is greedy, or sampled at a temperature by the Gumbel-max trick
(``sample_logits``). ``refresh``
hot-swaps weights: in full, or sparsely, where only the leaves a new
checkpoint changed are copied to the device into a copy-on-write clone of
the live tree (O(changed tensors) of H2D, bit-identical to a full reload).
``changed_tensor_paths`` plans that sparse update from the store's records
alone, without reading a blob.

``CheckpointFollower`` closes the §III.C redeployment loop for serving:
instead of re-downloading whole checkpoints, it pulls per-save DELTAS from
the training store (``core.registry.replicate_fanout`` — one have-set
negotiation, only changed chunks over the wire, incremental verification),
or applies published bundles from a passive registry, and the delta stays
sparse all the way into the model: ``poll`` compares the pulled revision's
records against the previous one (pure metadata), assembles ONLY the
changed tensors from the local store as host tensors, and
``poll_and_refresh(engine)`` hands them to ``Engine.refresh``, which puts
just those leaves on the engine's device. The follower itself never picks
a device. With ``verify=True`` (the default) every pulled revision's
consumed blobs are re-hashed before the engine sees them; a corrupt
revision gets one in-line ``repair_image`` from the followed remote, and
if that cannot heal it the poll returns None and the engine keeps serving
its last-known-good weights.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (Any, Dict, Iterable, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from ..core import (LayerStore, PassiveRegistry, PushRejected, PushStats,
                    RelayNode, diff_tensor_records, import_delta,
                    plan_bundle_chain, repair_image, replicate_fanout,
                    sha256_hex)
from ..device import resolve_device
from ..ft.faults import CrashInjected, fault_point
from ..ft.retry import RetryPolicy
from ..kernels.flash_attention import ops as flash_ops
from ..models import decode_step, init_cache, prefill
from ..models.config import ModelConfig
from ..tracing import recording, span


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, steps)
    logits_last: np.ndarray


def changed_tensor_paths(store: LayerStore, image: str, old_tag: str,
                         new_tag: str) -> Optional[Set[str]]:
    """The sparse-refresh plan between two tags a store holds: tensor
    names whose stored chunk lists differ (metadata only, no blob reads).
    None = structural change or unreadable base: the caller must fall back
    to a full reload."""
    try:
        old_m, _ = store.read_image(image, old_tag)
        new_m, _ = store.read_image(image, new_tag)
        old_layers = [store.read_layer(lid) for lid in old_m.layer_ids]
        new_layers = [store.read_layer(lid) for lid in new_m.layer_ids]
    except (OSError, ValueError, KeyError):
        return None
    return diff_tensor_records(old_layers, new_layers)


@dataclass
class SparseUpdate:
    """One checkpoint transition as ``CheckpointFollower.poll`` returns
    it. Iterates as the historical ``(step, params, opt_state)`` triple;
    ``changed_params``/``changed_opt`` name the leaf paths that actually
    moved ('/'-joined, relative to each tree's root). ``None`` means a
    FULL update (first poll, or sparse fallback) — params/opt_state then
    hold the whole trees; otherwise they hold ONLY the changed leaves.
    Always consume as ``engine.refresh(upd.params, upd.changed_params)``
    (correct for both cases); a bare full swap of a sparse update's
    partial tree would drop the unchanged weights — callers that need the
    old whole-tree-every-poll behavior pass ``sparse=False`` to the
    follower."""

    step: int
    params: Any
    opt_state: Any
    changed_params: Optional[Set[str]] = None
    changed_opt: Optional[Set[str]] = None
    tensors_loaded: int = 0       # tensors assembled from the local store

    @property
    def full(self) -> bool:
        return self.changed_params is None

    def __iter__(self):
        yield from (self.step, self.params, self.opt_state)


@dataclass
class FollowerHealth:
    """Structured liveness snapshot of a ``CheckpointFollower`` — what a
    fleet controller reads to decide whether a replica is merely lagging
    (staleness grows, failures transient) or sick (consecutive failures
    climbing, same error repeating) and should be drained."""

    polls: int                      # poll() calls made
    failures: int                   # polls that raised
    consecutive_failures: int       # current unbroken failure run
    last_success_step: Optional[int]
    staleness_s: Optional[float]    # seconds since the last applied update
    retries_spent: int              # in-run retries the pull path consumed
    last_error: Optional[str]
    corrupt_polls: int = 0          # polls whose revision failed re-hash
    repairs: int = 0                # in-line repair_image heals attempted
    last_verify_error: Optional[str] = None   # why the last gate refused


@dataclass
class PassivePullStats:
    """Accounting for one passive (bundle-registry) pull: which chain the
    planner chose and what it actually cost. ``negotiations`` stays 0 on
    the passive path BY CONSTRUCTION — the plan comes entirely from the
    published index — and the bench counter-proves it."""

    hops: int = 0                   # bundle edges applied
    bytes_pulled: int = 0           # encoded bundle bytes fetched
    planned_bytes: int = 0          # the chain's ADVERTISED byte cost
    negotiations: int = 0           # have-set rounds (passive path: zero)
    edges_skipped: int = 0          # unusable edges dropped mid-pull
    fallback: str = ""              # "" | "remote" (smart pull took over)


@dataclass
class EngineHealth:
    """Snapshot of the serving engine's weight freshness."""

    refreshes: int
    last_refresh_leaves: int
    last_refresh_step: Optional[int]
    staleness_s: Optional[float]    # seconds since the last weight swap
    rollbacks: int = 0              # last-known-good restores performed
    last_rollback_step: Optional[int] = None  # step serving after the last one


def _leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaves(v) for v in tree.values())
    return 1


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.nbytes


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def sample_logits(logits: torch.Tensor, temperature: float,
                  gen: torch.Generator) -> torch.Tensor:
    """One token per row of ``logits`` (..., V): the argmax when
    ``temperature <= 0``, else a draw from ``softmax(logits /
    temperature)`` by the Gumbel-max trick, the method of
    ``jax.random.categorical``: ``argmax(logits / T + g)`` with ``g =
    -log(-log(u))`` and ``u`` uniform from ``gen``. JAX's bits cannot be
    reproduced in torch, so sampled tokens are held to the reference by
    their law, not token for token."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    g = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits.float() / temperature + g, dim=-1)


class Engine:
    """Serves one model on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.max_len = max_len
        self.last_refresh_leaves = 0
        self._refreshes = 0
        self._last_refresh_t: Optional[float] = None
        self._last_refresh_step: Optional[int] = None
        # last-known-good history (one level deep): the live tree is
        # stashed at the top of every refresh, so rollback() can undo a
        # swap that went bad
        self._prev_params: Optional[Any] = None
        self._prev_step: Optional[int] = None
        self._rollbacks = 0
        self._last_rollback_step: Optional[int] = None
        self._batches = 0               # generate calls: a span's ``seq``

    def health(self) -> EngineHealth:
        return EngineHealth(
            refreshes=self._refreshes,
            last_refresh_leaves=self.last_refresh_leaves,
            last_refresh_step=self._last_refresh_step,
            staleness_s=None if self._last_refresh_t is None
            else time.monotonic() - self._last_refresh_t,
            rollbacks=self._rollbacks,
            last_rollback_step=self._last_rollback_step)

    def refresh(self, params, changed: Optional[Iterable[str]] = None,
                step: Optional[int] = None) -> int:
        """Hot-swap weights. ``changed=None`` replaces the whole tree. With
        ``changed`` (leaf paths, '/'-joined), ``params`` need only hold
        those leaves: each is copied to the device into a copy-on-write
        clone of the live tree (unchanged leaves stay resident and shared),
        which is bit-identical to a full reload of the same revision.
        Returns the number of leaves swapped in."""
        with span("engine.refresh", full=changed is None) as sp:
            n, nbytes = self._refresh(params, changed, step)
            sp.set(leaves=n, bytes=nbytes)
        return n

    def _refresh(self, params, changed: Optional[Iterable[str]],
                 step: Optional[int]) -> Tuple[int, int]:
        """``refresh``'s swap -> (leaves swapped in, bytes copied to the
        device; the full path counts its bytes only while tracing)."""
        # stash last-known-good BEFORE any mutation: the sparse path is
        # copy-on-write, so the stashed tree is never aliased into the new
        self._prev_params = self.params
        self._prev_step = self._last_refresh_step
        if changed is None:
            self.params = _to_device(params, self.device)
            self.last_refresh_leaves = _leaves(params)
            self._stamp_refresh(step)
            return self.last_refresh_leaves, \
                _nbytes(params) if recording() else 0
        root = dict(self.params)
        fresh = {id(root)}          # nodes already copied this refresh
        n = nbytes = 0
        for path in sorted(set(changed)):
            node, parts = root, path.split("/")
            for p in parts[:-1]:
                nxt = node.get(p)
                if not isinstance(nxt, dict):
                    raise KeyError(
                        f"changed path {path!r}: {p!r} is not a subtree "
                        "of the live params (stale sparse plan? use a "
                        "full refresh)")
                if id(nxt) not in fresh:
                    nxt = dict(nxt)
                node[p] = nxt
                fresh.add(id(nxt))
                node = nxt
            if parts[-1] not in node:
                raise KeyError(
                    f"changed path {path!r} is not a leaf of the live "
                    "params (stale sparse plan? use a full refresh)")
            leaf = params
            for p in parts:
                leaf = leaf[p]
            node[parts[-1]] = leaf.to(self.device)
            n += 1
            nbytes += leaf.nbytes
        self.params = root
        self.last_refresh_leaves = n
        self._stamp_refresh(step)
        return n, nbytes

    def rollback(self) -> bool:
        """Restore the param tree that served before the last ``refresh``
        (the very object that was serving: sparse refreshes never mutate
        it). One level deep; False when there is nothing to roll back to."""
        if self._prev_params is None:
            return False
        self.params, self._prev_params = self._prev_params, None
        self._last_refresh_step, self._prev_step = self._prev_step, None
        self._rollbacks += 1
        self._last_rollback_step = self._last_refresh_step
        return True

    def _stamp_refresh(self, step: Optional[int]) -> None:
        self._refreshes += 1
        self._last_refresh_t = time.monotonic()
        if step is not None:
            self._last_refresh_step = step

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, steps: int,
                 temperature: float = 0.0, seed: int = 0,
                 stop_token: Optional[int] = None) -> GenerationResult:
        """prompts: (B, S) int32, all of one length. The arguments are the
        reference's, in its order. ``temperature <= 0`` decodes greedily;
        above it each token is drawn by ``sample_logits`` from one
        generator on the engine's device, seeded with ``seed``, that draws
        once for the first token and once a step after that (the
        reference's ``key, sub = split(key)`` sequence).

        Spans: ``engine.prefill`` runs to the first token's copy to the
        host (attribute ``attn_kernel_launches``: the flash attention
        kernel's launches in the prefill, one an attention layer where
        ``models.attention.uses_kernel`` holds, else 0), and each
        ``engine.decode_step`` to the copy of the token it produced (the
        last one to ``logits_last``'s); each copy is an
        ``engine.token_wait``, the host blocked on the device."""
        B, S = prompts.shape
        if S + steps > self.max_len and not self.cfg.window:
            raise ValueError("prompt + steps exceeds the cache")
        self._batches += 1
        with span("engine.generate", batch=B, prompt=S, steps=steps,
                  seq=self._batches):
            gen = torch.Generator(device=self.device).manual_seed(seed)
            out = np.zeros((B, steps), np.int32)
            with span("engine.prefill") as sp:
                launched = flash_ops.flash_attention.launches
                cache = init_cache(self.cfg, B, self.max_len, self.device)
                # prefill builds a cache sized cache_len(S); splice it into
                # the full-size decode cache ring-consistently
                pf_cache, logits = prefill(
                    self.cfg, self.params,
                    torch.as_tensor(prompts, dtype=torch.long,
                                    device=self.device))
                sp.set(attn_kernel_launches=flash_ops.flash_attention.launches
                       - launched)
                cache = self._splice(cache, pf_cache, S)
                tok = self._sample(logits, temperature, gen)
                with span("engine.token_wait"):
                    if steps:
                        out[:, 0] = tok.cpu().numpy()
                    else:
                        logits_last = logits.float().cpu().numpy()
            for i in range(steps):
                # token i is on the host already: stop after its step
                stop = stop_token is not None and \
                    bool((out[:, i] == stop_token).all())
                last = stop or i == steps - 1
                with span("engine.decode_step", pos=S + i):
                    cache, logits = decode_step(self.cfg, self.params, cache,
                                                tok, S + i)
                    tok = self._sample(logits, temperature, gen)
                    with span("engine.token_wait"):
                        if last:
                            logits_last = logits.float().cpu().numpy()
                        else:
                            out[:, i + 1] = tok.cpu().numpy()
                if stop:
                    out = out[:, :i + 1]
                    break
        return GenerationResult(tokens=out, logits_last=logits_last)

    def _sample(self, logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        return sample_logits(logits[..., :self.cfg.vocab], temperature, gen)

    def _splice(self, cache: Dict, pf_cache: Dict, S: int) -> Dict:
        """Insert the prefill cache (length C_pf, ring layout) into the
        decode cache (length C_full) preserving slot = pos % C."""
        out = {}
        for name, full in cache.items():
            pf = pf_cache[name]
            if full.shape == pf.shape:
                out[name] = pf
                continue
            C_full, C_pf = full.shape[2], pf.shape[2]
            # prefill ring holds positions S-C_pf..S-1 at slot pos % C_pf;
            # unroll to chronological, then place at pos % C_full
            start = S - C_pf
            idx = torch.as_tensor((start + np.arange(C_pf)) % C_pf,
                                  device=full.device)
            slots = torch.as_tensor((start + np.arange(C_pf)) % C_full,
                                    device=full.device)
            full[:, :, slots] = pf[:, :, idx]   # a fresh cache: in place
            out[name] = full
        return out


class CheckpointFollower:
    """Keep a serving store in sync with a training store by pulling
    per-save deltas (see module docstring).

    ``remote`` is the training-side LayerStore (or its path); ``local`` is
    this server's store. ``poll()`` pulls any checkpoint newer than the
    last one seen — O(changed bytes) on the wire — and returns a
    ``SparseUpdate`` (iterates as the historical (step, params, opt_state)
    triple) ready for ``Engine.refresh``, or None when already up to date.
    With ``sparse`` (the default) every poll after the first assembles
    ONLY the tensors whose records changed between the previous and the
    pulled revision — O(changed tensors) of local blob reads — and names
    them in ``changed_params``/``changed_opt`` so the engine can
    device-put just those leaves; structural changes fall back to a full
    load. The local store keeps the ``keep`` newest checkpoints and
    mark-and-sweeps the rest after each pull, so a long-running replica's
    disk stays bounded (mirrors CheckpointManager._gc on the training
    side).

    ``image=`` names the followed image, and the local store may be
    SHARED by several followers (one per tenant) and by a pre-seeded base
    image: the pull negotiates against the local store's whole committed
    namespace (cross-image holdings), so the first poll of a fresh
    fine-tune over a base-holding store transfers only the adapter delta,
    and retention is cross-image safe — ``prune_steps`` removes only THIS
    image's stale step tags, and the store-wide ``gc()`` it triggers
    never sweeps a blob any sibling image (or lease) still reaches.

    ``children`` turns this follower into a RELAY: each poll pulls the
    delta once from the trainer and re-fans it to the downstream stores
    (edge tier) through the same negotiated plan — streaming from the
    in-flight pull by default (``source="inflight"``), with every child's
    commit gated on the local commit. Child outcomes land in ``last_fan``
    (per-child failure isolation; a sick edge never blocks this replica's
    own refresh, and the next poll's re-fan converges it). Every child
    store shares this follower's ``keep`` retention, so edge disks stay
    bounded too.

    Retention races are survived, not raised: a trainer that prunes the
    tag mid-pull makes ``poll`` return None (the next poll sees a newer
    tag), and a pruned-away base revision just downgrades the sparse plan
    to a full update.
    """

    IMAGE = "ckpt"

    def __init__(self, remote, local, image: str = IMAGE, keep: int = 2,
                 sparse: bool = True, children: Sequence = (),
                 source: str = "inflight",
                 retry: Optional[RetryPolicy] = None,
                 verify: bool = True,
                 registry=None):
        if remote is None and registry is None:
            raise ValueError("follower needs a remote store, a passive "
                             "registry, or both")
        self.remote = None if remote is None else (
            remote if isinstance(remote, LayerStore)
            else LayerStore(str(remote)))
        # passive bundle registry (a PassiveRegistry, or a directory path /
        # http(s) URL): polls plan the cheapest published chain from its
        # signed index — zero negotiation round-trips — and only fall back
        # to the smart ``remote`` pull when no advertised chain works.
        # remote=None makes the follower FULLY passive: it can serve from a
        # dumb file/object store with no training-side endpoint at all.
        self.registry = registry if registry is None or \
            isinstance(registry, PassiveRegistry) \
            else PassiveRegistry(str(registry))
        self.local = local if isinstance(local, LayerStore) \
            else LayerStore(str(local))
        self.relay = RelayNode(self.local, children=children,
                               source=source, retry=retry) if children \
            else None
        self.image = image
        self.keep = keep
        self.sparse = sparse
        self.retry = retry            # in-run self-healing for the pull
        self.verify = verify          # re-hash every revision pre-swap
        self.last_step: Optional[int] = None
        self.last_pull: Optional[PushStats] = None
        self.last_plan: Optional[PassivePullStats] = None
        self.last_update: Optional[SparseUpdate] = None
        self.last_fan = None          # child-tier FanoutStats (relay mode)
        self._polls = 0
        self._failures = 0
        self._consecutive_failures = 0
        self._retries_spent = 0
        self._last_success_t: Optional[float] = None
        self._last_error: Optional[str] = None
        self._corrupt_polls = 0
        self._repairs = 0
        self.last_verify_error: Optional[str] = None

    def health(self) -> FollowerHealth:
        """Structured snapshot for fleet controllers: staleness is seconds
        since the last APPLIED update (None before the first), consecutive
        failures reset on any clean poll — including an up-to-date None."""
        return FollowerHealth(
            polls=self._polls, failures=self._failures,
            consecutive_failures=self._consecutive_failures,
            last_success_step=self.last_step,
            staleness_s=None if self._last_success_t is None
            else time.monotonic() - self._last_success_t,
            retries_spent=self._retries_spent,
            last_error=self._last_error,
            corrupt_polls=self._corrupt_polls,
            repairs=self._repairs,
            last_verify_error=self.last_verify_error)

    def _pull(self, tag: str) -> Optional[PushStats]:
        """One delta pull (re-fanned to children in relay mode), hardened
        against the retention race: if the trainer pruned ``tag`` between
        ``latest_step`` and the pull, give up quietly — the next poll sees
        a newer tag. Anything that fails while the remote still HAS the
        tag is a real error and re-raises (after ``retry`` converged or
        quarantined, when one is configured)."""
        try:
            fault_point("follower.pull",
                        f"{self.local.root}:{self.image}:{tag}")
            fan = replicate_fanout(self.remote,
                                   [self.relay or self.local],
                                   self.image, tag, retry=self.retry)
            self._retries_spent += fan.retries_spent
            rep = fan.replicas[0]
            if rep.exception is not None:
                raise rep.exception
            if self.relay is not None:
                self.last_fan = rep.children
            return rep.stats
        except (OSError, PushRejected):
            if self.remote.has_image(self.image, tag):
                raise
            return None

    def _read_index(self):
        """The registry's signed index, or None when it is missing,
        unreachable, truncated or fails its signature — an unusable
        advertisement is a reason to fall back, never a poll error."""
        if self.registry is None:
            return None
        try:
            return self.registry.read_index(self.image)
        except (OSError, ConnectionError, ValueError):
            return None

    def _pull_passive(self, index, tag: str) -> Optional[PushStats]:
        """Reach ``tag`` by applying published bundles along the cheapest
        advertised chain — zero negotiation round-trips (the plan comes
        entirely from the index; ``import_delta`` on a plain store never
        calls ``negotiate``). Every hop is verified against the index's
        size + sha256 and re-verified content-addressed on receipt; an
        edge that fails ANY of that — fetch error, hash mismatch, a
        bundle whose endpoint tags the publisher or this store pruned —
        is skipped and the chain replanned without it, never raised.
        Returns None when no advertised chain can reach ``tag`` (the
        caller falls back to the smart remote pull, when there is one)."""
        plan_stats = PassivePullStats()
        self.last_plan = plan_stats
        held = set(self.local.list_tags(self.image, fresh=True))
        skip: Set = set()
        agg: Optional[PushStats] = None
        while True:
            plan = plan_bundle_chain(index, held, head=tag, skip=skip)
            if plan is None:
                return None
            if not plan:
                break
            entry = plan[0]
            try:
                data = self.registry.fetch_bundle(self.image, entry)
                stats = import_delta(self.relay or self.local, data)
            except (ConnectionError, OSError, PushRejected, ValueError,
                    KeyError):
                skip.add((entry.from_tag, entry.to_tag))
                plan_stats.edges_skipped += 1
                continue
            plan_stats.hops += 1
            plan_stats.bytes_pulled += len(data)
            plan_stats.planned_bytes += entry.size
            held.add(entry.to_tag)
            if agg is None:
                agg = stats
            else:
                for f in ("blobs_sent", "blobs_dedup", "layers_sent",
                          "layers_dedup", "bytes_sent", "bytes_payload",
                          "bytes_meta", "bytes_deduped",
                          "layers_deep_verified", "layers_rekey_verified",
                          "blobs_hashed_remote"):
                    setattr(agg, f, getattr(agg, f) + getattr(stats, f))
                agg.wall_s += stats.wall_s
        return agg if agg is not None else PushStats()

    def poll(self) -> Optional[SparseUpdate]:
        """Health-instrumented wrapper over the sync step: failures are
        COUNTED (consecutive run + last error) before re-raising, so a
        crashing poll leaves a readable record; see ``health()``."""
        self._polls += 1
        try:
            with span("follower.poll") as sp:
                upd = self._poll_inner()
                if upd is not None:
                    sp.set(step=upd.step, full=upd.full)
        except Exception as e:  # noqa: BLE001
            self._failures += 1
            self._consecutive_failures += 1
            self._last_error = f"{type(e).__name__}: {e}"
            raise
        self._consecutive_failures = 0
        self._last_error = None
        if upd is not None:
            self._last_success_t = time.monotonic()
        return upd

    def _poll_inner(self) -> Optional[SparseUpdate]:
        # lazy import: ckpt depends on core only, but keep serve->ckpt
        # out of module import time. The shared helpers guarantee the
        # replica and the trainer agree on tag format + retention.
        from ..ckpt.manager import (latest_step, prune_steps, step_of_tag,
                                    unflatten_tree)
        # head discovery: the signed bundle index (passive) and/or the
        # remote's tag listing (smart). A stale index can trail the
        # trainer, so with both available the newer head wins; fresh=True
        # on the remote because the trainer commits tags from another
        # process/instance, invisible to its commit-point cache.
        index = self._read_index()
        passive_step = None if index is None else step_of_tag(index.head)
        remote_step = None if self.remote is None else \
            latest_step(self.remote, self.image, fresh=True)
        step = max((s for s in (passive_step, remote_step) if s is not None),
                   default=None)
        if step is None or \
                (self.last_step is not None and step <= self.last_step):
            return None
        tag = f"step-{step:08d}"
        pulled = None
        with span("follower.pull") as sp:
            if index is not None and passive_step == step:
                pulled = self._pull_passive(index, tag)
                if pulled is None and self.last_plan is not None and \
                        self.remote is not None:
                    self.last_plan.fallback = "remote"
            if pulled is None and self.remote is not None:
                pulled = self._pull(tag)
            if pulled is not None:
                sp.set(bytes_sent=pulled.bytes_sent,
                       blobs_sent=pulled.blobs_sent,
                       blobs_hashed_remote=pulled.blobs_hashed_remote)
        if pulled is None:           # tag pruned mid-pull / no usable
            return None              # chain: retry next poll
        self.last_pull = pulled
        # sparse plan BEFORE retention prunes the previous tag away
        changed: Optional[Set[str]] = None
        if self.sparse and self.last_step is not None:
            prev_tag = f"step-{self.last_step:08d}"
            with span("follower.plan"):
                changed = changed_tensor_paths(self.local, self.image,
                                               prev_tag, tag)
        # verify gate: re-hash exactly the blobs this refresh will consume
        # BEFORE assembling tensors from them. A corrupt revision (at-rest
        # bit-rot, a persisted torn write) gets one in-line anti-entropy
        # heal from the followed remote; if that cannot produce a clean
        # revision the poll returns None WITHOUT advancing last_step — the
        # engine keeps serving last-known-good weights and the next poll
        # retries the same tag against a possibly-healthier remote.
        if self.verify:
            with span("follower.verify") as sp:
                hashed = [0, 0]             # blobs, bytes
                bad = self._verify_revision(tag, changed, hashed)
                if bad:
                    self._corrupt_polls += 1
                    if self._repair_revision(tag):
                        bad = self._verify_revision(tag, changed, hashed)
                sp.set(blobs=hashed[0], bytes=hashed[1])
            if bad:
                self.last_verify_error = (
                    f"{tag}: {bad[0]}" +
                    (f" (+{len(bad) - 1} more)" if len(bad) > 1 else ""))
                return None
        with span("follower.load") as sp:
            flat = self.local.load_image_payload(
                self.image, tag, names=None if changed is None else changed)
            if recording():
                sp.set(tensors=len(flat),
                       bytes=sum(t.nbytes for t in flat.values()))
        self.last_step = step
        # retention: drop superseded local checkpoints + sweep their blobs
        # — at EVERY tier this follower feeds, or the edge stores would
        # accumulate one committed step per poll forever
        with span("follower.prune"):
            prune_steps(self.local, self.image, self.keep)
            if self.relay is not None:
                for s in self.relay.all_stores():
                    if s is not self.local:
                        prune_steps(s, self.image, self.keep)
        opt_flat = {k[len("opt/"):]: v for k, v in flat.items()
                    if k.startswith("opt/")}
        opt_flat.pop("__step__", None)
        params_flat = {k[len("params/"):]: v for k, v in flat.items()
                       if k.startswith("params/")}
        self.last_update = SparseUpdate(
            step=step,
            params=unflatten_tree(params_flat),
            opt_state=unflatten_tree(opt_flat),
            changed_params=None if changed is None else
            {k[len("params/"):] for k in changed
             if k.startswith("params/")},
            changed_opt=None if changed is None else
            {k[len("opt/"):] for k in changed
             if k.startswith("opt/") and k != "opt/__step__"},
            tensors_loaded=len(flat),
        )
        return self.last_update

    def _verify_revision(self, tag: str, changed: Optional[Set[str]],
                         hashed: List[int]) -> List[str]:
        """Re-hash the local blobs the coming refresh will consume —
        scoped to the sparse plan's changed tensors when there is one (the
        unchanged leaves already serve from device memory; their disk
        state is the background scrub's business, not this hot path's).
        Returns human-readable problems, empty = clean; ``hashed`` (blobs,
        bytes) adds up what was re-hashed."""
        st = self.local
        problems: List[str] = []
        try:
            manifest, _ = st.read_image(self.image, tag)
            for lid in manifest.layer_ids:
                layer = st.read_layer(lid, use_cache=False)
                for rec in layer.records:
                    if changed is not None and rec.name not in changed:
                        continue
                    for h in rec.chunks:
                        try:
                            data = st.read_blob(h)
                            hashed[0] += 1
                            hashed[1] += len(data)
                            if sha256_hex(data) != h:
                                problems.append(
                                    f"corrupt blob {h[:12]} ({rec.name})")
                        except OSError:
                            problems.append(
                                f"missing blob {h[:12]} ({rec.name})")
        except (OSError, ValueError, KeyError) as e:
            problems.append(f"revision metadata unreadable: {e}")
        return problems

    def _repair_revision(self, tag: str) -> bool:
        """One in-line anti-entropy heal of a corrupt pulled revision from
        the followed remote (core.registry.repair_image: quarantine the
        bad blobs, pull only the damaged bytes, deep-verify). True = the
        revision is clean again and the poll may proceed. A fully passive
        follower (no remote) has no live peer to heal from — it refuses
        the revision and keeps serving last-known-good."""
        if self.remote is None:
            self.last_verify_error = \
                f"repair of {tag} skipped: no remote peer"
            return False
        try:
            rep = repair_image(self.local, self.image, tag,
                               peers=[self.remote])
        except CrashInjected:
            raise           # the follower process dying mid-repair must
            # surface from poll(), not read as "repair failed, refused"
        except Exception as e:  # noqa: BLE001
            self.last_verify_error = \
                f"repair of {tag} failed: {type(e).__name__}: {e}"
            return False
        self._repairs += 1
        return rep.verified_clean

    def poll_and_refresh(self, engine: Engine) -> Optional[SparseUpdate]:
        """Closed-loop sync: poll once and hot-swap ``engine``, never
        letting a bad revision take the server down. A wire fault
        (``ConnectionError`` — which injected chaos faults subclass) is
        swallowed: the engine keeps serving its current weights and the
        next call retries. A refresh that dies mid-swap rolls the engine
        back to the previous committed params (``Engine.rollback``)
        instead of leaving a torn tree. Returns the applied update, or
        None when nothing changed or nothing could be SAFELY applied
        (``health()`` tells the two apart)."""
        with span("follower.sync") as sp:
            try:
                upd = self.poll()
            except ConnectionError:
                return None               # counted by poll(); serve stale
            if upd is None:
                return None
            sp.set(step=upd.step)
            try:
                engine.refresh(upd.params, upd.changed_params, step=upd.step)
            except Exception as e:  # noqa: BLE001
                engine.rollback()
                self.last_verify_error = \
                    f"refresh rolled back: {type(e).__name__}: {e}"
                return None
            return upd
