"""Assigned input shapes and abstract input specs (torch port of
``repro/configs/shapes.py``).

LM transformer shapes are seq_len x global_batch. ``decode_*`` / ``long_*``
are one new token with a KV cache of seq_len, NOT a train step.
``long_500k`` runs only for sub-quadratic archs (SSM / hybrid / SWA).
The specs are meta-device tensors: shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from ..models import init_cache
from ..models.config import ModelConfig
from ..models.layers import as_torch_dtype


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    sp = SHAPES[shape_name]
    B, S = sp.global_batch, sp.seq_len
    prefix = {}
    if cfg.n_prefix_embeds:
        prefix["prefix_embeds"] = _spec((B, cfg.n_prefix_embeds, cfg.d_model),
                                        as_torch_dtype(cfg.compute_dtype))
    if sp.kind == "train":
        return {"tokens": _spec((B, S), torch.int32),
                "labels": _spec((B, S), torch.int32),
                "mask": _spec((B, S), torch.float32), **prefix}
    if sp.kind == "prefill":
        return {"tokens": _spec((B, S), torch.int32), **prefix}
    if sp.kind == "decode":
        return {"cache": init_cache(cfg, B, S, device="meta"),
                "tokens": _spec((B,), torch.int32),
                "pos": _spec((), torch.int32)}
    raise ValueError(sp.kind)
