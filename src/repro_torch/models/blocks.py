"""Per-family blocks: init, prefill apply, decode step (torch port of the
dense, ssm and hybrid families in ``repro/models/blocks.py``; moe and mla
are not ported yet).

Every family exposes, through the ``FAMILY_*`` tables:
    init(cfg, generator, device, n_layers)    -> params, layer-stacked
    apply(cfg, p, x, positions, collect_cache) -> (x', cache_entry|None)
    decode(cfg, p, cache, x_t, pos)            -> (cache', x_t')
and ``init_layer_cache(cfg, batch, cache_len, device)``.

Weights are head-structured (d, H, Dh) / (H, Dh, d). Caches hold ungrouped
K/V (KVH heads); SWA archs use a ring buffer of ``window`` slots. Decode
updates the K/V cache tensors IN PLACE (the JAX code returns new arrays; the
port writes one slot instead of copying the cache every step) and returns
the same tensors; the SSM states come back as new tensors, as in JAX, and
the caller writes them into its stacked cache.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .attention import attention, attention_decode
from .config import ModelConfig
from .layers import (apply_rope, as_torch_dtype, dense, proj_heads, rms_norm,
                     trunc_normal, unproj_heads)
from .ssm import (causal_conv, causal_conv_step, ssd_chunked,
                  ssd_decode_step)

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


def _attn_init(cfg: ModelConfig, generator: torch.Generator, device,
               n_layers: int) -> Dict:
    d, L = cfg.d_model, n_layers
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = as_torch_dtype(cfg.param_dtype)

    def head(shape, std):
        return trunc_normal(shape, std, dt, generator, device)

    return {
        "wq": head((L, d, H, Dh), d ** -0.5),
        "wk": head((L, d, KVH, Dh), d ** -0.5),
        "wv": head((L, d, KVH, Dh), d ** -0.5),
        "wo": head((L, H, Dh, d), (H * Dh) ** -0.5),
    }


def _mlp_init(cfg: ModelConfig, generator: torch.Generator, device,
              n_layers: int) -> Dict:
    d, L, F = cfg.d_model, n_layers, cfg.d_ff
    dt = as_torch_dtype(cfg.param_dtype)
    return {
        "w_gate": trunc_normal((L, d, F), d ** -0.5, dt, generator, device),
        "w_up": trunc_normal((L, d, F), d ** -0.5, dt, generator, device),
        "w_down": trunc_normal((L, F, d), F ** -0.5, dt, generator, device),
    }


def _ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


def init_dense_block(cfg: ModelConfig, generator: torch.Generator, device,
                     n_layers: int) -> Dict:
    """The dense block's params with a leading ``n_layers`` dim (the JAX
    package's vmapped, layer-stacked layout)."""
    d, L = cfg.d_model, n_layers
    return {
        "attn_norm": _ones((L, d), device),
        "mlp_norm": _ones((L, d), device),
        **_attn_init(cfg, generator, device, n_layers),
        **_mlp_init(cfg, generator, device, n_layers),
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


# ==================================================================== ssm
def _ssm_dims(cfg: ModelConfig):
    di, N, G, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    return di, N, G, Hs, di // Hs


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (log(1 + e^x) everywhere; torch's softplus
    switches to the identity above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def init_ssm_core(cfg: ModelConfig, generator: torch.Generator, device,
                  n_layers: int) -> Dict:
    di, N, G, Hs, P = _ssm_dims(cfg)
    d, K, L = cfg.d_model, cfg.conv_kernel, n_layers
    dt = as_torch_dtype(cfg.param_dtype)

    def head(shape, std):
        return trunc_normal((L,) + shape, std, dt, generator, device)

    def uniform(shape, lo, hi):
        return torch.empty((L,) + shape, dtype=torch.float32,
                           device=device).uniform_(lo, hi, generator=generator)

    def conv(shape):
        return (torch.randn((L,) + shape, generator=generator, device=device)
                / K).to(dt)

    u = uniform((Hs,), 1e-3, 1e-1)
    dt_bias = u + torch.log(-torch.expm1(-u))       # inverse softplus
    zeros = lambda shape: torch.zeros((L,) + shape,  # noqa: E731
                                      dtype=torch.float32, device=device)
    return {
        "w_z": head((d, Hs, P), d ** -0.5),
        "w_x": head((d, Hs, P), d ** -0.5),
        "w_B": head((d, G, N), d ** -0.5),
        "w_C": head((d, G, N), d ** -0.5),
        "w_dt": head((d, Hs), d ** -0.5),
        "conv_x_w": conv((Hs, P, K)),
        "conv_x_b": zeros((Hs, P)),
        "conv_B_w": conv((G, N, K)),
        "conv_B_b": zeros((G, N)),
        "conv_C_w": conv((G, N, K)),
        "conv_C_b": zeros((G, N)),
        "A_log": torch.log(uniform((Hs,), 1.0, 16.0)),
        "D": _ones((L, Hs), device),
        "dt_bias": dt_bias,
        "gate_norm": _ones((L, Hs, P), device),
        "out_proj": head((Hs, P, d), di ** -0.5),
    }


def _gated_rms(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               eps: float) -> torch.Tensor:
    """RMSNorm(y * silu(z)) jointly over the (H, P) channel block."""
    g = y.float() * torch.nn.functional.silu(z.float())
    var = torch.mean(g * g, dim=(-2, -1), keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def ssm_scan_inputs(cfg: ModelConfig, p: Dict, h: torch.Tensor):
    """The first half of ``apply_ssm_core``: projections, causal convs and
    step sizes. h: (B, S, d) normed -> (z, (x_pre, B_pre, C_pre), scan)
    where ``scan`` holds the SSD inputs x, dt, A, Bc, Cc, D by name."""
    z = proj_heads(h, p["w_z"])                              # (B,S,H,P)
    x_pre = proj_heads(h, p["w_x"])
    B_pre = proj_heads(h, p["w_B"])                          # (B,S,G,N)
    C_pre = proj_heads(h, p["w_C"])
    dt = dense(h, p["w_dt"])                                 # (B,S,H)
    silu = torch.nn.functional.silu
    scan = {
        "x": silu(causal_conv(x_pre, p["conv_x_w"], p["conv_x_b"])),
        "dt": _softplus(dt.float() + p["dt_bias"]),
        "A": -torch.exp(p["A_log"]),
        "Bc": silu(causal_conv(B_pre, p["conv_B_w"], p["conv_B_b"])),
        "Cc": silu(causal_conv(C_pre, p["conv_C_w"], p["conv_C_b"])),
        "D": p["D"],
    }
    return z, (x_pre, B_pre, C_pre), scan


def apply_ssm_core(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                   collect_cache: bool = False):
    """h: (B, S, d) normed input -> (y (B,S,d), cache|None)."""
    z, (x_pre, B_pre, C_pre), scan = ssm_scan_inputs(cfg, p, h)
    y, h_final = ssd_chunked(**scan, chunk=cfg.ssm_chunk)
    y = _gated_rms(y, z, p["gate_norm"], cfg.rms_eps)
    out = unproj_heads(y, p["out_proj"])
    cache = None
    if collect_cache:
        K = cfg.conv_kernel
        cdt = as_torch_dtype(cfg.compute_dtype)

        def tail(t):     # chronological last K-1 inputs (left-pad if short)
            if t.shape[1] >= K - 1:
                return t[:, -(K - 1):].to(cdt)
            pad = torch.zeros((t.shape[0], K - 1 - t.shape[1])
                              + tuple(t.shape[2:]), dtype=t.dtype,
                              device=t.device)
            return torch.cat([pad, t], dim=1).to(cdt)

        cache = {"conv_x": tail(x_pre), "conv_B": tail(B_pre),
                 "conv_C": tail(C_pre), "h": h_final}
    return out, cache


def init_ssm_block(cfg: ModelConfig, generator: torch.Generator, device,
                   n_layers: int) -> Dict:
    return {"norm": _ones((n_layers, cfg.d_model), device),
            **init_ssm_core(cfg, generator, device, n_layers)}


def apply_ssm_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                    positions: torch.Tensor, collect_cache: bool = False):
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    y, cache = apply_ssm_core(cfg, p, h, collect_cache)
    return x + y, cache


def ssm_cache_init(cfg: ModelConfig, batch: int, device,
                   cache_len: int = 0) -> Dict:
    di, N, G, Hs, P = _ssm_dims(cfg)
    K = cfg.conv_kernel
    cdt = as_torch_dtype(cfg.compute_dtype)
    return {"conv_x": torch.zeros((batch, K - 1, Hs, P), dtype=cdt,
                                  device=device),
            "conv_B": torch.zeros((batch, K - 1, G, N), dtype=cdt,
                                  device=device),
            "conv_C": torch.zeros((batch, K - 1, G, N), dtype=cdt,
                                  device=device),
            "h": torch.zeros((batch, Hs, P, N), dtype=torch.float32,
                             device=device)}


def decode_ssm_core(cfg: ModelConfig, p: Dict, cache: Dict, h: torch.Tensor):
    """h: (B, d) normed -> (new cache tensors, y (B, d))."""
    z = proj_heads(h, p["w_z"])                              # (B,H,P)
    x_pre = proj_heads(h, p["w_x"])
    B_pre = proj_heads(h, p["w_B"])
    C_pre = proj_heads(h, p["w_C"])
    dt = dense(h, p["w_dt"])
    conv_x, xs = causal_conv_step(cache["conv_x"], x_pre, p["conv_x_w"],
                                  p["conv_x_b"])
    conv_B, Bc = causal_conv_step(cache["conv_B"], B_pre, p["conv_B_w"],
                                  p["conv_B_b"])
    conv_C, Cc = causal_conv_step(cache["conv_C"], C_pre, p["conv_C_w"],
                                  p["conv_C_b"])
    silu = torch.nn.functional.silu
    xs, Bc, Cc = silu(xs), silu(Bc), silu(Cc)
    dtf = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h_new, y = ssd_decode_step(cache["h"], xs, dtf, A, Bc, Cc, p["D"])
    y = _gated_rms(y, z, p["gate_norm"], cfg.rms_eps)
    out = unproj_heads(y, p["out_proj"])
    return {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
            "h": h_new}, out


def decode_ssm_block(cfg: ModelConfig, p: Dict, cache: Dict,
                     x_t: torch.Tensor, pos: int):
    h = rms_norm(x_t, p["norm"], cfg.rms_eps)
    cache, y = decode_ssm_core(cfg, p, cache, h)
    return cache, x_t + y


# ================================================================= hybrid
def init_hybrid_block(cfg: ModelConfig, generator: torch.Generator, device,
                      n_layers: int) -> Dict:
    d, L = cfg.d_model, n_layers
    return {
        "norm": _ones((L, d), device),
        "mlp_norm": _ones((L, d), device),
        "attn_fuse_norm": _ones((L, d), device),
        "ssm_fuse_norm": _ones((L, d), device),
        "attn": _attn_init(cfg, generator, device, n_layers),
        "ssm": init_ssm_core(cfg, generator, device, n_layers),
        **_mlp_init(cfg, generator, device, n_layers),
    }


def apply_hybrid_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       positions: torch.Tensor, collect_cache: bool = False):
    """Hymba-style: attention heads and SSM heads read the same input in
    parallel; outputs are RMS-normed and averaged (the paper's mean fusion)."""
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    attn_out, k, v = _self_attention(cfg, p["attn"], h, positions)
    ssm_out, ssm_cache = apply_ssm_core(cfg, p["ssm"], h, collect_cache)
    fused = 0.5 * (rms_norm(attn_out, p["attn_fuse_norm"], cfg.rms_eps) +
                   rms_norm(ssm_out, p["ssm_fuse_norm"], cfg.rms_eps))
    x = x + fused
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    x = x + _mlp(cfg, p, h2)
    cache = None
    if collect_cache:
        C = cfg.cache_len(x.shape[1])
        cache = {"k": _ring_tail(k, C), "v": _ring_tail(v, C), **ssm_cache}
    return x, cache


def hybrid_cache_init(cfg: ModelConfig, batch: int, cache_len: int,
                      device) -> Dict:
    return {**_kv_cache_init(cfg, batch, cache_len, device),
            **ssm_cache_init(cfg, batch, device)}


def decode_hybrid_block(cfg: ModelConfig, p: Dict, cache: Dict,
                        x_t: torch.Tensor, pos: int):
    h = rms_norm(x_t, p["norm"], cfg.rms_eps)
    kv_cache = {"k": cache["k"], "v": cache["v"]}
    kv_cache, attn_out = _attn_decode(cfg, p["attn"], kv_cache, h, pos)
    ssm_cache = {k2: cache[k2] for k2 in ("conv_x", "conv_B", "conv_C", "h")}
    ssm_cache, ssm_out = decode_ssm_core(cfg, p["ssm"], ssm_cache, h)
    fused = 0.5 * (rms_norm(attn_out, p["attn_fuse_norm"], cfg.rms_eps) +
                   rms_norm(ssm_out, p["ssm_fuse_norm"], cfg.rms_eps))
    x_t = x_t + fused
    h2 = rms_norm(x_t, p["mlp_norm"], cfg.rms_eps)
    x_t = x_t + _mlp(cfg, p, h2)
    return {**kv_cache, **ssm_cache}, x_t


# ============================================================== dispatch
FAMILY_INIT = {"dense": init_dense_block, "ssm": init_ssm_block,
               "hybrid": init_hybrid_block}
FAMILY_APPLY = {"dense": apply_dense_block, "ssm": apply_ssm_block,
                "hybrid": apply_hybrid_block}
FAMILY_DECODE = {"dense": decode_dense_block, "ssm": decode_ssm_block,
                 "hybrid": decode_hybrid_block}


def init_layer_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    if cfg.family == "dense":
        return _kv_cache_init(cfg, batch, cache_len, device)
    if cfg.family == "ssm":
        return ssm_cache_init(cfg, batch, device)
    if cfg.family == "hybrid":
        return hybrid_cache_init(cfg, batch, cache_len, device)
    raise NotImplementedError(
        f"the torch port has no {cfg.family!r} block yet")
