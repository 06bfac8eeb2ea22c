"""Shared neural-net primitives (torch port of ``repro/models/layers.py``).

Matrix products go to ``torch.matmul``, as the JAX package leaves them to
XLA. Weights keep the JAX layouts: ``(d_in, d_out)`` dense, ``(d, H, Dh)``
head projections and ``(H, Dh, d)`` output projections.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

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


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) in x's dtype."""
    return torch.matmul(x, w.to(x.dtype))


def proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d) @ w: (d, H, Dh) -> (..., H, Dh)."""
    d, H, Dh = w.shape
    return dense(x, w.reshape(d, H * Dh)).reshape(*x.shape[:-1], H, Dh)


def unproj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., H, Dh) @ w: (H, Dh, d) -> (..., d)."""
    H, Dh, d = w.shape
    return dense(x.reshape(*x.shape[:-2], H * Dh), w.reshape(H * Dh, d))


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
    freqs = _rope_freqs_on(D, theta, str(x.device))              # (D/2,)
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

