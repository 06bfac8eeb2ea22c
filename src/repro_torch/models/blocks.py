"""The dense transformer block: init, prefill apply, decode step (torch port
of the dense family in ``repro/models/blocks.py``).

Weights are head-structured (d, H, Dh) / (H, Dh, d). Caches hold ungrouped
K/V (KVH heads); SWA archs use a ring buffer of ``window`` slots. Decode
updates the cache tensors IN PLACE (the JAX code returns new arrays; the
port writes one slot instead of copying the cache every step) and returns
the same dict.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .attention import attention, attention_decode
from .config import ModelConfig
from .layers import (apply_rope, as_torch_dtype, dense, proj_heads, rms_norm,
                     trunc_normal, unproj_heads)

_INT32_MAX = 2 ** 31 - 1


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def _qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor,
         positions: torch.Tensor):
    q = proj_heads(x, p["wq"])
    k = proj_heads(x, p["wk"])
    v = proj_heads(x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attention(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                    positions: torch.Tensor):
    """-> (attn output (B,S,d), k, v)."""
    q, k, v = _qkv(cfg, p, h, positions)
    rep = cfg.n_heads // cfg.n_kv_heads
    o = attention(q, _repeat_kv(k, rep), _repeat_kv(v, rep), causal=True,
                  window=cfg.window, impl=cfg.attn_impl,
                  kv_block=cfg.kv_block, q_block=cfg.q_block,
                  score_dtype=cfg.score_dtype)
    return unproj_heads(o, p["wo"]), k, v


def _mlp(cfg: ModelConfig, p: Dict, h: torch.Tensor) -> torch.Tensor:
    g = dense(h, p["w_gate"])
    u = dense(h, p["w_up"])
    if cfg.act == "swiglu":
        hh = torch.nn.functional.silu(g) * u
    else:
        hh = torch.nn.functional.gelu(g, approximate="tanh") * u
    return dense(hh, p["w_down"])


def _ring_tail(k: torch.Tensor, C: int) -> torch.Tensor:
    """Last C positions of k (B,S,...) laid out ring-style (slot = pos % C)
    so decode's ``pos % C`` insertion continues consistently."""
    S = k.shape[1]
    if S < C:
        pad = torch.zeros((k.shape[0], C - S) + tuple(k.shape[2:]),
                          dtype=k.dtype, device=k.device)
        return torch.cat([pad, k], dim=1)
    tail = k[:, -C:]
    shift = S % C
    return torch.roll(tail, shift, dims=1) if shift else tail


def _kv_cache_init(cfg: ModelConfig, batch: int, cache_len: int,
                   device) -> Dict:
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    dt = as_torch_dtype(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _cache_positions(cache_len: int, pos: int, device) -> torch.Tensor:
    """Absolute position held in each ring slot; invalid slots get INT_MAX."""
    s = torch.arange(cache_len, device=device)
    cand = pos - torch.remainder(pos - s, cache_len)
    return torch.where(cand >= 0, cand, torch.full_like(cand, _INT32_MAX))


def _kv_cache_insert(cache: Dict, k_t: torch.Tensor, v_t: torch.Tensor,
                     pos: int) -> Dict:
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot:slot + 1] = k_t
    cache["v"][:, slot:slot + 1] = v_t
    return cache


def _attn_decode(cfg: ModelConfig, p: Dict, cache: Dict, x_t: torch.Tensor,
                 pos: int) -> Tuple[Dict, torch.Tensor]:
    B = x_t.shape[0]
    x1 = x_t[:, None]                                       # (B, 1, d)
    q = proj_heads(x1, p["wq"])
    k = proj_heads(x1, p["wk"])
    v = proj_heads(x1, p["wv"])
    pos_b = torch.full((B, 1), pos, device=x_t.device)
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    cache = _kv_cache_insert(cache, k, v, pos)
    cpos = _cache_positions(cache["k"].shape[1], pos, x_t.device)
    o = attention_decode(q, cache["k"], cache["v"], cpos, pos,
                         window=cfg.window)
    y = unproj_heads(o, p["wo"])[:, 0]
    return cache, y


def init_dense_block(cfg: ModelConfig, generator: torch.Generator, device,
                     n_layers: int) -> Dict:
    """The dense block's params with a leading ``n_layers`` dim (the JAX
    package's vmapped, layer-stacked layout)."""
    d, L = cfg.d_model, n_layers
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = as_torch_dtype(cfg.param_dtype)

    def head(shape, std):
        return trunc_normal(shape, std, dt, generator, device)

    return {
        "attn_norm": torch.ones((L, d), dtype=torch.float32, device=device),
        "mlp_norm": torch.ones((L, d), dtype=torch.float32, device=device),
        "wq": head((L, d, H, Dh), d ** -0.5),
        "wk": head((L, d, KVH, Dh), d ** -0.5),
        "wv": head((L, d, KVH, Dh), d ** -0.5),
        "wo": head((L, H, Dh, d), (H * Dh) ** -0.5),
        "w_gate": head((L, d, cfg.d_ff), d ** -0.5),
        "w_up": head((L, d, cfg.d_ff), d ** -0.5),
        "w_down": head((L, cfg.d_ff, d), cfg.d_ff ** -0.5),
    }


def apply_dense_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                      positions: torch.Tensor, collect_cache: bool = False):
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    a, k, v = _self_attention(cfg, p, h, positions)
    x = x + a
    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    x = x + _mlp(cfg, p, h)
    cache = None
    if collect_cache:
        C = cfg.cache_len(x.shape[1])
        cache = {"k": _ring_tail(k, C), "v": _ring_tail(v, C)}
    return x, cache


def decode_dense_block(cfg: ModelConfig, p: Dict, cache: Dict,
                       x_t: torch.Tensor, pos: int):
    h = rms_norm(x_t, p["attn_norm"], cfg.rms_eps)
    cache, a = _attn_decode(cfg, p, cache, h, pos)
    x_t = x_t + a
    h = rms_norm(x_t, p["mlp_norm"], cfg.rms_eps)
    x_t = x_t + _mlp(cfg, p, h)
    return cache, x_t
