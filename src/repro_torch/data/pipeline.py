"""Deterministic synthetic token pipeline (a copy of
``repro/data/pipeline.py``'s numpy part, so batches are bit-identical).

Tokens are a pure function of (seed, step, global position) via a splitmix
hash, so any host can materialize exactly its shard without coordination,
and resuming at step k regenerates the identical batch k.

``make_global_batch`` lays a host batch onto a ``DeviceMesh`` as DTensors,
each rank building only its own shard (the reference's per-shard
callbacks). On one device the train step moves a host batch to the card
itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..sharding.ctx import from_full
from ..sharding.rules import PartitionSpec


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclass
class SyntheticTokens:
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch for a step (any slice of it is shard-local)."""
        idx = (np.uint64(self.seed) * np.uint64(1_000_003) +
               np.uint64(step) * np.uint64(self.batch * (self.seq + 1)) +
               np.arange(self.batch * (self.seq + 1), dtype=np.uint64))
        with np.errstate(over="ignore"):
            toks = (_splitmix(idx) % np.uint64(self.vocab)).astype(np.int32)
        toks = toks.reshape(self.batch, self.seq + 1)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
            "mask": np.ones((self.batch, self.seq), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch(ds: SyntheticTokens, step: int,
               prefix_embeds: Optional[np.ndarray] = None):
    b = ds.batch_at(step)
    if prefix_embeds is not None:
        b["prefix_embeds"] = prefix_embeds
        b["mask"][:, :prefix_embeds.shape[1]] = 0.0
    return b


def make_global_batch(mesh, specs: Dict[str, PartitionSpec],
                      host_batch: Dict[str, np.ndarray]):
    """DTensors on ``mesh`` from a host batch that every rank can compute:
    each rank builds only its own block of each array, at ``specs``'s
    placements (``sharding.ctx.from_full``; the index is the one the
    reference's per-shard callbacks get for the device at the same mesh
    position). Names without a spec are replicated."""
    return {name: from_full(torch.as_tensor(np.asarray(arr)), mesh,
                            specs.get(name, PartitionSpec()))
            for name, arr in host_batch.items()}
