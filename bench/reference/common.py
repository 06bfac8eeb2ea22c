"""Plain building blocks of the references: float32 tensors and plain torch
operations, no kernel, no cache, no batching trick.

``precision`` selects how every dense product rounds its inputs:
"f32" keeps them as they are; "fp8" rounds both operands to float8 e4m3
with one scale per tensor (the step below the served bfloat16), which is
the control that a check has to refuse. The rounding passes gradients
through unchanged, so the same code serves a training control.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0     # largest finite float8 e4m3fn


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for matmul and cuDNN, restored
    on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, returned in
    float32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., k) @ w (k, n) in float32, the inputs rounded per
    ``precision``."""
    w = w.float()
    if precision == "fp8":
        x, w = fp8(x), fp8(w)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of x (..., T, [H,] D), split
    halves; the angles in float64."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = positions.to(torch.float64)[:, None] * inv            # (T, D/2)
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    if x.dim() == 4:                                             # head axis
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, q_block: int = 512) -> torch.Tensor:
    """softmax(q k^T * scale, causal) v over query blocks: q, k (B, T, H,
    D), v (B, T, H, Dv), one key head per query head -> (B, T, H, Dv)."""
    T = q.shape[1]
    out = []
    for s in range(0, T, q_block):
        e = min(T, s + q_block)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, s:e], k[:, :e]) * scale
        keep = torch.arange(s, e, device=q.device)[:, None] >= \
            torch.arange(e, device=q.device)[None, :]
        sc = sc.masked_fill(~keep, float("-inf"))
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                                v[:, :e]))
    return torch.cat(out, dim=1)


def swiglu_mlp(h: torch.Tensor, w_gate, w_up, w_down,
               precision: str) -> torch.Tensor:
    g = matmul(h, w_gate, precision)
    u = matmul(h, w_up, precision)
    return matmul(torch.nn.functional.silu(g) * u, w_down, precision)


def normal_tree(spec: dict, generator: torch.Generator, device,
                dtype: torch.dtype) -> dict:
    """Weights for a tree of ``{path: (shape, std)}`` (std None: ones in
    float32) drawn in one call from ``generator`` into one buffer of
    ``dtype`` on ``device``, each leaf a contiguous view of it scaled in
    place; leaves start on 256-element boundaries."""
    align = 256
    sizes = {p: _numel(s) for p, (s, std) in spec.items() if std is not None}
    total = sum(-(-n // align) * align for n in sizes.values())
    buf = torch.randn(total, dtype=dtype, device=device, generator=generator)
    flat, off = {}, 0
    for path, (shape, std) in spec.items():
        if std is None:
            flat[path] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = sizes[path]
        flat[path] = buf[off:off + n].view(shape).mul_(std)
        off += -(-n // align) * align
    return unflatten(flat)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def unflatten(flat: dict) -> dict:
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(flatten(tree[k], path))
        else:
            out[path] = tree[k]
    return out
