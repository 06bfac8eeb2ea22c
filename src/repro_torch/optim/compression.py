"""Gradient compression: int8 block-quantized all-reduce with error feedback
(torch port of ``repro/optim/compression.py``).

The DP gradient all-reduce is the dominant inter-pod collective at scale.
This module halves its bytes (bf16 -> int8 + f32 scale per 2048-block)
with error feedback, so quantization error is carried into the next step
instead of lost (Seide et al. / 1-bit Adam lineage).

Scheme (exact-summable): every replica quantizes against a SHARED per-block
scale (max of the local scales over the replicas — one tiny f32
collective), so the int8 payloads sum exactly in int32; the result is
rescaled once. Error feedback is computed against the actually-transmitted
value. Rounding is half-to-even, as ``jnp.round``'s.

The reference's ``compressed_psum`` only runs compiled (inside
``shard_map``), where XLA turns each division by a constant (the 127 of
the scale, the replica count of the mean) into a product with the
constant's f32 reciprocal, and fuses the error's multiply-subtract into
one rounding; the port computes the same, so its results are the
reference's bit for bit. ``quantize_int8`` divides, as
the reference's does op by op.

``compressed_psum`` runs on each rank's local tensors (inside
``sharding.local_call``, the reference's ``shard_map``): ``axis_names``
name dimensions of the mesh, whose process groups carry the max of the
scales and the int32 sum. As in the reference, no step calls it:
``TrainConfig.grad_compression`` is read nowhere.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from ..sharding.ctx import current_mesh

BLOCK = 2048


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)


def _unblocks(b: torch.Tensor, shape, dtype) -> torch.Tensor:
    n = math.prod(shape)
    return b.reshape(-1)[:n].reshape(shape).to(dtype)


def _quantize(blk: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(blk / torch.clamp(scale, min=1e-12)[:, None])
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 blocks (nb, BLOCK), f32 scales (nb,))."""
    blk = _blocks(g)
    scale = torch.amax(torch.abs(blk), dim=1) / 127.0
    return _quantize(blk, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    return _unblocks(q.to(torch.float32) * scale[:, None], shape, dtype)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, axis_names,
                    mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-all-reduce of the local ``g`` over the mesh dimensions
    ``axis_names`` with an int8 payload; ``mesh`` defaults to the one of
    the enclosing ``activation_ctx``.

    Returns (mean grad f32 (g.shape), new error feedback (g.shape))."""
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh: pass mesh= or call "
                         "it inside activation_ctx(rules, mesh)")
    groups = [mesh.get_group(a) for a in axis_names]
    replicas = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                         for a in axis_names)

    target = _blocks(g) + _blocks(err)
    shared_scale = torch.amax(torch.abs(target), dim=1) * _recip(127)
    for group in groups:                                        # tiny f32
        dist.all_reduce(shared_scale, dist.ReduceOp.MAX, group=group)
    q = _quantize(target, shared_scale)                         # int8 payload
    # target - q * scale rounded once, as XLA's fused multiply-subtract
    # rounds it (the f64 product and difference are exact)
    new_err = _unblocks((target.double() - q.double()
                         * shared_scale.double()[:, None]).float(),
                        g.shape, torch.float32)
    acc = q.to(torch.int32)
    for group in groups:                                        # exact
        dist.all_reduce(acc, dist.ReduceOp.SUM, group=group)
    mean = _unblocks(acc.to(torch.float32) * shared_scale[:, None]
                     * _recip(replicas), g.shape, torch.float32)
    return mean, new_err


def _recip(n: int) -> float:
    """1/n rounded to f32: XLA's form of a division by the constant n."""
    return torch.tensor(1.0 / n, dtype=torch.float32).item()


def init_error_feedback(params):
    """f32 zeros shaped like every leaf of ``params``."""
    if isinstance(params, dict):
        return {k: init_error_feedback(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)
