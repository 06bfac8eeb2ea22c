"""Attention — memory-bounded plain torch implementations (port of
``repro/models/attention.py``; the JAX model runs these in pure jnp, so the
port does too: no fused attention operator stands in for them).

* ``attention_blockwise`` — a loop over KV blocks with online softmax.
* ``attention_banded`` — sliding-window attention: a loop over query
  blocks, each attending to a fixed-size (window + q_block) KV slice.
* ``attention_decode`` — single-query attention over a cache (optionally a
  ring buffer for SWA).

All operate on (B, S, H, D) layouts with GQA grouping handled by reshaping
q to (B, KVH, G, S, D). Score and value products take their inputs'
values exactly and accumulate in f32, as the JAX code's
``preferred_element_type=float32`` asks.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import as_torch_dtype, rounded

NEG_INF = -1e30


def _split_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, Hq, D) -> (B, KVH, G, S, D)"""
    B, S, Hq, D = q.shape
    G = Hq // n_kv
    return q.reshape(B, S, n_kv, G, D).permute(0, 2, 3, 1, 4)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, KVH, G, S, D) -> (B, S, Hq, D)"""
    B, KVH, G, S, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, KVH * G, D)


def _scores(qh: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """einsum("bhgqd,bhkd->bhgqk") in f32."""
    return torch.matmul(qh.float(), kb.float()[:, :, None].transpose(-1, -2))


def _values(p: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """einsum("bhgqk,bhkd->bhgqd") in f32."""
    return torch.matmul(p.float(), vb.float()[:, :, None])


def _scale(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """q * scale in q's dtype (the JAX code scales before the product)."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    return q * rounded(s, q.dtype)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None,
                        kv_block: int = 512,
                        scale: Optional[float] = None,
                        score_dtype=torch.float32) -> torch.Tensor:
    """q: (B, S, Hq, Dk); k: (B, S, KVH, Dk); v: (B, S, KVH, Dv)."""
    B, S, Hq, Dk = q.shape
    KVH = k.shape[2]
    Dv = v.shape[3]
    score_dtype = as_torch_dtype(score_dtype)
    kv_block = min(kv_block, S)
    while S % kv_block:
        kv_block //= 2
    nb = S // kv_block

    qh = _split_heads(_scale(q, scale), KVH)               # (B,KVH,G,S,Dk)
    kh = k.permute(0, 2, 1, 3)                             # (B,KVH,S,Dk)
    vh = v.permute(0, 2, 1, 3)                             # (B,KVH,S,Dv)
    q_pos = torch.arange(S, device=q.device)
    G = Hq // KVH

    m = torch.full((B, KVH, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KVH, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KVH, G, S, Dv), dtype=torch.float32,
                      device=q.device)
    for j in range(nb):
        kb = kh[:, :, j * kv_block:(j + 1) * kv_block]
        vb = vh[:, :, j * kv_block:(j + 1) * kv_block]
        s = _scores(qh, kb).to(score_dtype)
        kv_pos = j * kv_block + torch.arange(kv_block, device=q.device)
        mask = torch.ones((S, kv_block), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - kv_pos[None, :] < window
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1).float())
        p = torch.exp(s - m_new[..., None].to(score_dtype))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.float().sum(dim=-1)
        acc = acc * alpha[..., None] + _values(p.to(vb.dtype), vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return _merge_heads(out).to(q.dtype)


def attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, q_block: int = 512,
                     scale: Optional[float] = None,
                     score_dtype=torch.float32) -> torch.Tensor:
    """Sliding-window causal attention, O(S·window): each query block
    attends to the KV slice [start, start + window + q_block), start =
    max(0, block_end - span), and masking fixes up the overlap."""
    B, S, Hq, Dk = q.shape
    KVH = k.shape[2]
    Dv = v.shape[3]
    score_dtype = as_torch_dtype(score_dtype)
    q_block = min(q_block, S)
    while S % q_block:
        q_block //= 2
    nqb = S // q_block
    span = min(S, window + q_block)

    qh = _split_heads(_scale(q, scale), KVH)               # (B,KVH,G,S,D)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    G = Hq // KVH
    outs = []
    for i in range(nqb):
        q0 = i * q_block
        qb = qh[:, :, :, q0:q0 + q_block]
        start = max(q0 + q_block - span, 0)
        kb = kh[:, :, start:start + span]
        vb = vh[:, :, start:start + span]
        s = _scores(qb, kb).to(score_dtype)
        q_pos = q0 + torch.arange(q_block, device=q.device)
        kv_pos = start + torch.arange(span, device=q.device)
        mask = (q_pos[:, None] >= kv_pos[None, :]) & \
               (q_pos[:, None] - kv_pos[None, :] < window)
        s = s.masked_fill(~mask, NEG_INF)
        mx = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - mx)
        l = p.float().sum(dim=-1, keepdim=True)
        outs.append(_values((p.float() / torch.clamp(l, min=1e-30))
                            .to(vb.dtype), vb))
    out = torch.cat(outs, dim=3).reshape(B, KVH, G, S, Dv)
    return _merge_heads(out).to(q.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_positions: torch.Tensor,
                     pos: int, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention.

    q: (B, 1, Hq, Dk); caches: (B, C, KVH, D); cache_positions: (C,) the
    absolute position stored in each cache slot (ring-aware); pos: the
    current token's position (its K/V must already be in the cache).
    """
    KVH = k_cache.shape[2]
    qh = _split_heads(_scale(q, scale), KVH)               # (B,KVH,G,1,D)
    kh = k_cache.permute(0, 2, 1, 3)                       # (B,KVH,C,D)
    vh = v_cache.permute(0, 2, 1, 3)
    s = _scores(qh, kh)
    valid = cache_positions <= pos
    if window is not None:
        valid &= pos - cache_positions < window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _values(p.to(vh.dtype), vh)
    return _merge_heads(o).to(q.dtype)


def attention(q, k, v, *, causal=True, window=None, impl="auto",
              kv_block=512, q_block=512, scale=None,
              score_dtype=torch.float32):
    """Dispatcher used by model blocks (self-attention, S_q == S_kv)."""
    if impl == "auto":
        impl = "banded" if (window is not None and window < q.shape[1]) \
            else "blockwise"
    if impl == "banded":
        if window is None:
            raise ValueError("banded attention needs a window")
        return attention_banded(q, k, v, window=window, q_block=q_block,
                                scale=scale, score_dtype=score_dtype)
    return attention_blockwise(q, k, v, causal=causal, window=window,
                               kv_block=kv_block, scale=scale,
                               score_dtype=score_dtype)
