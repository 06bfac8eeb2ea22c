"""CheckpointManager — training state as layered, content-addressed images
(torch port of ``repro/ckpt/manager.py``: synchronous saves and restore).

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

Leaves stay on their device until a chunk range is actually needed.
Retention (``keep``) is not ported yet: it needs the store's gc.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import (BuildReport, Instruction, LayerStore, diff_image,
                    fingerprint_tree_packed, inject_image_multi)
from ..device import resolve_device


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


@dataclass
class CheckpointPolicy:
    incremental: bool = True          # the paper's technique (vs baseline)
    use_fingerprints: bool = False    # on-device change detection
    chunk_bytes: int = 1 << 20
    durability: str = "batch"         # per-chunk fsyncs defer to one
                                      # concurrent flush at the commit


class CheckpointManager:
    """See module docstring. ``image=`` names this manager's image (default
    ``"ckpt"``)."""

    IMAGE = "ckpt"

    def __init__(self, root: str, arch: str,
                 policy: Optional[CheckpointPolicy] = None,
                 image: Optional[str] = None):
        self.policy = policy or CheckpointPolicy()
        self.store = LayerStore(root, chunk_bytes=self.policy.chunk_bytes,
                                durability=self.policy.durability)
        self.image = image or self.IMAGE
        self.arch = arch
        self._last_fps: Dict[str, np.ndarray] = {}
        self.last_report: Optional[BuildReport] = None

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

    def save(self, step: int, params, opt_state) -> BuildReport:
        """Full or incremental save per policy; returns its BuildReport."""
        payloads = self._payloads(params, opt_state, step)
        if self.policy.incremental and self.latest_step() is not None:
            report = self._save_incremental(step, payloads)
        else:
            report = self._save_full(step, payloads)
        self.last_report = report
        return report

    def _compute_fps(self, payloads: Dict[str, Dict[str, torch.Tensor]],
                     stats: dict) -> Dict[str, np.ndarray]:
        """Fingerprint every tensor of the checkpoint in one pass."""
        union: Dict[str, torch.Tensor] = {}
        for tree in payloads.values():
            union.update(tree)
        return fingerprint_tree_packed(union, self.policy.chunk_bytes,
                                       stats=stats)

    def _save_full(self, step: int,
                   payloads: Dict[str, Dict[str, torch.Tensor]],
                   fps: Optional[Dict[str, np.ndarray]] = None
                   ) -> BuildReport:
        prev = self.latest_step()
        parent = (self.image, self.tag_of(prev)) if prev is not None else None
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
        except Exception:  # noqa: BLE001
            # structure changed ("compiled" case), or any other failure of
            # the injection -> rebuild fall-back, as the reference does (it
            # re-raises its simulated crash, CrashInjected, first; the port
            # has no fault injection yet)
            report = self._save_full(step, payloads,
                                     fps=new_fps if new_fps else None)
        report.bytes_d2h += stats.get("bytes_d2h", 0)
        if self.policy.use_fingerprints:
            self._last_fps = new_fps or self._last_fps
        return report

    # ------------------------------------------------------------ restore
    def restore(self, step: Optional[int] = None, device=None
                ) -> Optional[Tuple[Any, Any, int]]:
        """-> (params, opt_state, step) with every tensor on ``device`` (the
        card unless ``device="cpu"`` is asked for), or None when the image
        has no checkpoint."""
        device = resolve_device(device)
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
