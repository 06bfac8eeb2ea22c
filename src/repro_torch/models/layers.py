"""Shared neural-net primitives (torch port of ``repro/models/layers.py``).

Matrix products go to ``torch.matmul``, as the JAX package leaves them to
XLA. Weights keep the JAX layouts: ``(d_in, d_out)`` dense, ``(d, H, Dh)``
head projections and ``(H, Dh, d)`` output projections.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch._guards import detect_fake_mode
from torch.utils.checkpoint import checkpoint

from ..sharding.ctx import in_current_ctx, local_call, settle

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def as_torch_dtype(d) -> torch.dtype:
    """A config's dtype name ("bfloat16") as a torch dtype."""
    return d if isinstance(d, torch.dtype) else _DTYPES[d]


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python number: multiplying a
    tensor by it equals multiplying by a 0-d tensor of that dtype (the JAX
    code's ``jnp.asarray(value, dtype)``) without a host-to-device copy,
    which would stall the stream."""
    return torch.tensor(value, dtype=dtype).item()


def recomputed(fn, *args):
    """``fn(*args)``, its intermediates recomputed in backward when autograd
    records through it (the JAX code's ``@jax.checkpoint`` on a scan body):
    backward then holds only ``args``, one block at a time. Non-reentrant,
    so grads also reach tensors that ``fn`` closes over."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(in_current_ctx(fn), *args, use_reentrant=False)
    return fn(*args)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) in x's dtype."""
    if _flattens_a_shard(x, w, 1):
        return _local_contract(x, w, 1)
    return torch.matmul(x, w.to(x.dtype))


def proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d) @ w: (d, H, Dh) -> (..., H, Dh)."""
    if _flattens_a_shard(x, w, 1):
        return _local_contract(x, w, 1)
    d, H, Dh = w.shape
    return dense(x, w.reshape(d, H * Dh)).reshape(*x.shape[:-1], H, Dh)


def unproj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., H, Dh) @ w: (H, Dh, d) -> (..., d)."""
    if _flattens_a_shard(x, w, 2):
        return _local_contract(x, w, 2)
    H, Dh, d = w.shape
    return dense(x.reshape(*x.shape[:-2], H * Dh), w.reshape(H * Dh, d))


# ------------------------------------------------- products on a mesh
def _blocks_flatten(t: torch.Tensor, first: int, last: int) -> bool:
    """Flattening dims first..last of ``t`` would mix a sharded dim with
    the dims before it, or split the group unevenly: its first dim
    sharded into unequal parts, or a pending sum that DTensor would
    scatter over it so."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor) or last <= first:
        return False
    mesh = t.device_mesh
    for i, p in enumerate(t.placements):
        uneven = t.shape[first] % mesh.size(i) != 0
        if p.is_partial() and uneven:
            return True
        if not isinstance(p, Shard):
            continue
        dim = p.dim % t.ndim
        if first < dim <= last or (dim == first and uneven):
            return True
    return False


def _flattens_a_shard(x: torch.Tensor, w: torch.Tensor, nc: int) -> bool:
    """The plain product of x (..., *c) and w (*c, *out) over ``nc`` dims
    would flatten a group of dims (x's leading ones, either side's
    contracted ones, w's output ones) that DTensor cannot flatten in
    place: torch 2.11 refuses an inner sharded dim (2.13 takes it as a
    strided shard), and both refuse an uneven split."""
    lead = x.ndim - nc
    return (_blocks_flatten(x, 0, lead - 1)
            or _blocks_flatten(x, lead, x.ndim - 1)
            or _blocks_flatten(w, 0, nc - 1)
            or _blocks_flatten(w, nc, w.ndim - 1))


def _local_contract(x: torch.Tensor, w: torch.Tensor,
                    nc: int) -> torch.Tensor:
    """x (..., *c) @ w (*c, *out) -> (..., *out) on each rank's blocks, as
    the reference's partitioner lays the product out, with no flatten of a
    sharded dim. On each mesh dim: a contracted dim sharded on either side
    gives a pending sum (both sides cut alike); an output dim of w sharded
    gives that dim of the result sharded (x gathered there); else x's
    leading shard carries through. Grads: a pending sum where the other
    operand's blocks split the work."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (x if isinstance(x, DTensor) else w).device_mesh

    def placed(t):
        if isinstance(t, DTensor):
            return settle(t)
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
    x, w = placed(x), placed(w)
    lead, rep = x.ndim - nc, Replicate()

    def even(p, t, i, kept):
        """A shard of a dim the result keeps must split evenly (the
        result's global shape is its blocks' times the mesh); else the
        dim is gathered on that mesh dim."""
        if isinstance(p, Shard) and kept(p.dim) and \
                t.shape[p.dim] % mesh.size(i):
            return rep
        return p
    x_in, w_in, out, x_grad, w_grad = [], [], [], [], []
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        px = even(px, x, i, lambda d: d < lead)
        pw = even(pw, w, i, lambda d: d >= nc)
        if isinstance(pw, Shard) and pw.dim < nc:          # contracted, in w
            xi = Shard(lead + pw.dim)
            row = (xi, pw, Partial(), xi, pw)
        elif isinstance(pw, Shard):                         # an output dim
            row = (rep, pw, Shard(lead + pw.dim - nc), Partial(), pw)
        elif isinstance(px, Shard) and px.dim < lead:       # a leading dim
            row = (px, rep, px, px, Partial())
        elif isinstance(px, Shard):                         # contracted, in x
            wi = Shard(px.dim - lead)
            row = (px, wi, Partial(), px, wi)
        else:
            row = (rep,) * 5
        for acc, p in zip((x_in, w_in, out, x_grad, w_grad), row):
            acc.append(p)

    def body(xl, wl):
        return torch.tensordot(xl, wl.to(xl.dtype), dims=nc)
    run = local_call(body, mesh, out, [x_in, w_in], [x_grad, w_grad])
    return run(x, w)


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    g = dense(x, w_gate)
    u = dense(x, w_up)
    if act == "swiglu":
        h = torch.nn.functional.silu(g) * u
    elif act == "geglu":
        h = torch.nn.functional.gelu(g, approximate="tanh") * u
    else:
        raise ValueError(act)
    return dense(h, w_down)


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: str) -> torch.Tensor:
    """The frequencies on a device, copied there once (read-only)."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: broadcastable to (..., S).
    Rotates the full last dim (D even), split-halves convention."""
    D = x.shape[-1]
    if detect_fake_mode() is None:
        freqs = _rope_freqs_on(D, theta, str(x.device))          # (D/2,)
    else:       # a trace on fake tensors: the cached real copy cannot mix
        freqs = torch.from_numpy(rope_freqs(D, theta)).to(x.device)
    ang = positions[..., None].float() * freqs                    # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == ang.dim() + 1:                                  # head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- init
def trunc_normal(shape, std: float, dtype: torch.dtype,
                 generator: torch.Generator, device) -> torch.Tensor:
    """Normal truncated to [-2, 2], times ``std``, drawn in f32 from
    ``generator`` (torch's numbers, not JAX's: weights that must equal the
    JAX package's are carried over with ``repro_torch.convert``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t.mul_(std)).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    """A (d_in, d_out) weight: ``trunc_normal`` with std ``d_in ** -0.5``."""
    return trunc_normal((d_in, d_out), d_in ** -0.5, dtype, generator, device)
