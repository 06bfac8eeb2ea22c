"""Batched serving engine: prefill once, decode step by step (torch port of
``Engine`` and ``changed_tensor_paths`` from ``repro/serve/engine.py``).

Decoding is greedy, as the parity with the JAX engine covers. ``refresh``
hot-swaps weights: in full, or sparsely, where only the leaves a new
checkpoint changed are copied to the device into a copy-on-write clone of
the live tree (O(changed tensors) of H2D, bit-identical to a full reload).
``changed_tensor_paths`` plans that sparse update from the store's records
alone, without reading a blob.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Set

import numpy as np
import torch

from ..core import LayerStore, diff_tensor_records
from ..device import resolve_device
from ..models import decode_step, init_cache, prefill
from ..models.config import ModelConfig


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


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


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
        # stash last-known-good BEFORE any mutation: the sparse path is
        # copy-on-write, so the stashed tree is never aliased into the new
        self._prev_params = self.params
        self._prev_step = self._last_refresh_step
        if changed is None:
            self.params = _to_device(params, self.device)
            self.last_refresh_leaves = _leaves(params)
            self._stamp_refresh(step)
            return self.last_refresh_leaves
        root = dict(self.params)
        fresh = {id(root)}          # nodes already copied this refresh
        n = 0
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
        self.params = root
        self.last_refresh_leaves = n
        self._stamp_refresh(step)
        return n

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
        """Greedy decode. prompts: (B, S) int32, all of one length. The
        arguments are the reference's, in its order; ``temperature > 0``
        raises ``NotImplementedError``, since the reference's sampled
        tokens (``jax.random.categorical`` from ``seed``) cannot be
        reproduced in torch."""
        if temperature > 0.0:
            raise NotImplementedError(
                f"temperature {temperature}: only greedy decoding "
                "(temperature 0) is ported")
        del seed                        # only sampling would read it
        B, S = prompts.shape
        if S + steps > self.max_len and not self.cfg.window:
            raise ValueError("prompt + steps exceeds the cache")
        cache = init_cache(self.cfg, B, self.max_len, self.device)
        # prefill builds a cache sized cache_len(S); splice it into the
        # full-size decode cache ring-consistently
        pf_cache, logits = prefill(
            self.cfg, self.params,
            torch.as_tensor(prompts, dtype=torch.long, device=self.device))
        cache = self._splice(cache, pf_cache, S)
        out = np.zeros((B, steps), np.int32)
        tok = self._sample(logits)
        for i in range(steps):
            out[:, i] = tok.cpu().numpy()
            cache, logits = decode_step(self.cfg, self.params, cache, tok,
                                        S + i)
            tok = self._sample(logits)
            if stop_token is not None and bool((out[:, i] == stop_token).all()):
                out = out[:, :i + 1]
                break
        return GenerationResult(tokens=out,
                                logits_last=logits.float().cpu().numpy())

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[..., :self.cfg.vocab], dim=-1)

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
