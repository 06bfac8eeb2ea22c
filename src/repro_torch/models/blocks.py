"""Per-family blocks: init, prefill apply, decode step (torch port of the
dense, moe, mla, ssm and hybrid families in ``repro/models/blocks.py``).

Every family exposes, through the ``FAMILY_*`` tables:
    init(cfg, generator, device, n_layers)    -> params, layer-stacked
    apply(cfg, p, x, positions, collect_cache) -> (x', aux, cache_entry|None)
    decode(cfg, p, cache, x_t, pos)            -> (cache', x_t')
and ``init_layer_cache(cfg, batch, cache_len, device)``; ``init_block``,
``apply_block`` and ``decode_block`` dispatch on ``cfg.family``, as the
reference's do. ``aux`` is a 0-d f32 tensor: the moe block's router
load-balancing loss, zero elsewhere.

Weights are head-structured (d, H, Dh) / (H, Dh, d). Caches hold ungrouped
K/V (KVH heads); SWA archs use a ring buffer of ``window`` slots; the mla
block caches its (kv_lora_rank + rope) latent. Decode updates the K/V and
latent cache tensors IN PLACE (the JAX code returns new arrays; the port
writes one slot instead of copying the cache every step) and returns the
same tensors; the SSM states come back as new tensors, as in JAX, and the
caller writes them into its stacked cache.

``constrain(x, name)`` pins named activations to the recipe's placements
at each of the reference's sites (a no-op outside a launcher's
``activation_ctx`` and on plain tensors). Under a rule table with
"moe_local" the moe block routes each shard's tokens on its own
(``_moe_local``); otherwise it routes all B*S tokens into one capacity
buffer, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..sharding.ctx import (constrain, current_mesh, current_rules,
                            local_call, partial_over, placements)
from .attention import attention, attention_decode
from .config import ModelConfig
from .layers import (apply_rope, as_torch_dtype, dense, proj_heads,
                     recomputed, rms_norm, trunc_normal, unproj_heads)
from .moe import moe_ffn
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
    return constrain(q, "act_q"), constrain(k, "act_kv"), \
        constrain(v, "act_kv")


def _self_attention(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                    positions: torch.Tensor):
    """-> (attn output (B,S,d), k, v)."""
    q, k, v = _qkv(cfg, p, h, positions)
    rep = cfg.n_heads // cfg.n_kv_heads
    kr = constrain(_repeat_kv(k, rep), "act_kv_rep")
    vr = constrain(_repeat_kv(v, rep), "act_kv_rep")
    o = attention(q, kr, vr, causal=True, window=cfg.window,
                  impl=cfg.attn_impl, kv_block=cfg.kv_block,
                  q_block=cfg.q_block, score_dtype=cfg.score_dtype)
    o = constrain(o, "act_q")
    return unproj_heads(o, p["wo"]), k, v


def _mlp(cfg: ModelConfig, p: Dict, h: torch.Tensor) -> torch.Tensor:
    g = constrain(dense(h, p["w_gate"]), "act_ffh")
    u = constrain(dense(h, p["w_up"]), "act_ffh")
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
    # torch.roll(tail, shift, dims=1) as two slices: DTensor has no
    # strategy for roll (torch 2.11)
    return torch.cat([tail[:, C - shift:], tail[:, :C - shift]], dim=1) \
        if shift else tail


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
    k = _write_slot(cache["k"], slot, k_t)
    v = _write_slot(cache["v"], slot, v_t)
    return {"k": constrain(k, "cache_kv"), "v": constrain(v, "cache_kv")}


def _write_slot(buf: torch.Tensor, slot: int, val: torch.Tensor
                ) -> torch.Tensor:
    """``buf[:, slot] = val``: in place on a plain tensor. A DTensor cache
    (a mesh's, its length sharded) gets a new tensor instead, the slot
    chosen by a mask that each shard applies to its own positions: a write
    through a view of a DTensor can land in a gathered copy."""
    if not isinstance(buf, DTensor):
        buf[:, slot:slot + 1] = val
        return buf
    hit = torch.arange(buf.shape[1], device=buf.device) == slot
    return torch.where(hit.reshape((1, -1) + (1,) * (buf.ndim - 2)), val,
                       buf)


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


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    """The aux loss of a block that has none: a 0-d f32 zero."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


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


def _block_out(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, a sublayer of the dense block. Under
    ``remat="outputs"`` its output is kept and its inside recomputed in
    backward: the tensors the JAX dense block names ``block_out``."""
    if cfg.remat == "outputs":
        return recomputed(fn, *args)
    return fn(*args)


def apply_dense_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                      positions: torch.Tensor, collect_cache: bool = False):
    # "act_block_in": under tp_sp the Megatron-SP gather point
    h = constrain(rms_norm(x, p["attn_norm"], cfg.rms_eps), "act_block_in")
    a, k, v = _block_out(cfg, _self_attention, cfg, p, h, positions)
    x = constrain(x + a, "act_hidden")
    h = constrain(rms_norm(x, p["mlp_norm"], cfg.rms_eps), "act_block_in")
    x = constrain(x + _block_out(cfg, _mlp, cfg, p, h), "act_hidden")
    cache = None
    if collect_cache:
        C = cfg.cache_len(x.shape[1])
        cache = {"k": _ring_tail(k, C), "v": _ring_tail(v, C)}
    return x, _no_aux(x), cache


def decode_dense_block(cfg: ModelConfig, p: Dict, cache: Dict,
                       x_t: torch.Tensor, pos: int):
    h = rms_norm(x_t, p["attn_norm"], cfg.rms_eps)
    cache, a = _attn_decode(cfg, p, cache, h, pos)
    x_t = x_t + a
    h = rms_norm(x_t, p["mlp_norm"], cfg.rms_eps)
    x_t = x_t + _mlp(cfg, p, h)
    return cache, x_t


# ==================================================================== moe
def init_moe_block(cfg: ModelConfig, generator: torch.Generator, device,
                   n_layers: int) -> Dict:
    d, L = cfg.d_model, n_layers
    E, fe = cfg.n_experts, cfg.d_ff_expert
    dt = as_torch_dtype(cfg.param_dtype)
    return {
        "attn_norm": _ones((L, d), device),
        "mlp_norm": _ones((L, d), device),
        **_attn_init(cfg, generator, device, n_layers),
        "router": trunc_normal((L, d, E), d ** -0.5, torch.float32,
                               generator, device),
        "w_gate": trunc_normal((L, E, d, fe), d ** -0.5, dt, generator,
                               device),
        "w_up": trunc_normal((L, E, d, fe), d ** -0.5, dt, generator, device),
        "w_down": trunc_normal((L, E, fe, d), fe ** -0.5, dt, generator,
                               device),
    }


def _moe(cfg: ModelConfig, p: Dict, h2d: torch.Tensor):
    return moe_ffn(h2d, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                   top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                   act=cfg.act)


_MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def _moe_local(cfg: ModelConfig, p: Dict, h: torch.Tensor, spec):
    """Fully-local MoE (the reference's ``shard_map`` over the token axes):
    each rank routes its own tokens of ``h`` (laid out by ``spec``) into its
    own capacity buffer against REPLICATED expert weights, whose grads are
    summed over the token axes; the router aux loss is averaged over them
    (the reference's ``pmean``). Used when the rule table provides
    "moe_local" (small-expert archs under sp)."""
    mesh = current_mesh()
    n = mesh.ndim
    hp = placements(mesh, spec, 3)
    rep = [Replicate()] * n
    # one aux per token shard: a vector sharded over the token axes, whose
    # mean is the pmean
    aux_p = [Shard(0) if isinstance(q, Shard) else Replicate() for q in hp]

    def body(hb, router, wg, wu, wd):
        B, S, d = hb.shape
        y, aux = moe_ffn(hb.reshape(B * S, d), router, wg, wu, wd,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, act=cfg.act)
        return y.reshape(B, S, d), aux.reshape(1)

    fn = local_call(body, mesh, (hp, aux_p), [hp] + [rep] * 4,
                    [hp] + [partial_over(mesh, spec, 3)] * 4)
    y, aux = fn(h, *(p[k] for k in _MOE_KEYS))
    return y, aux.mean()


def _moe_global(cfg: ModelConfig, p: Dict, h2d: torch.Tensor):
    """``_moe`` over all tokens at once. DTensor has no sharding strategy
    for the sort-based dispatch, so on a mesh the tokens and weights are
    gathered (replicated) and every rank routes the whole set, as the
    reference's partitioner computes it: same tokens, same capacity."""
    if not isinstance(h2d, DTensor):
        return _moe(cfg, p, h2d)
    mesh = h2d.device_mesh
    rep = [Replicate()] * mesh.ndim
    fn = local_call(lambda *a: _moe(cfg, dict(zip(_MOE_KEYS, a[1:])), a[0]),
                    mesh, (rep, rep), [rep] * 5, [rep] * 5)
    return fn(h2d, *(p[k] for k in _MOE_KEYS))


def apply_moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                    positions: torch.Tensor, collect_cache: bool = False):
    B, S, d = x.shape
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    a, k, v = _self_attention(cfg, p, h, positions)
    x = constrain(x + a, "act_hidden")
    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    local = current_rules().get("moe_local")
    if local is not None:
        # fully-local dispatch (see _moe_local)
        y3, aux = _moe_local(cfg, p, h, local)
        x = constrain(x + y3, "act_hidden")
    else:
        # pin the MoE input layout (all-gather in, reduce-scatter out: the
        # Megatron-SP MoE pattern) so flattening (B,S) never mixes sharded
        # dims inside the sort-based dispatch
        h = constrain(h, "act_moe_in")
        y, aux = _moe_global(cfg, p, h.reshape(B * S, d))
        x = constrain(x + constrain(y.reshape(B, S, d), "act_moe_out"),
                      "act_hidden")
    cache = None
    if collect_cache:
        C = cfg.cache_len(S)
        cache = {"k": _ring_tail(k, C), "v": _ring_tail(v, C)}
    return x, aux, cache


def decode_moe_block(cfg: ModelConfig, p: Dict, cache: Dict,
                     x_t: torch.Tensor, pos: int):
    h = rms_norm(x_t, p["attn_norm"], cfg.rms_eps)
    cache, a = _attn_decode(cfg, p, cache, h, pos)
    x_t = x_t + a
    h = rms_norm(x_t, p["mlp_norm"], cfg.rms_eps)
    y, _ = _moe_global(cfg, p, h)
    return cache, x_t + y


# ==================================================================== mla
def init_mla_block(cfg: ModelConfig, generator: torch.Generator, device,
                   n_layers: int) -> Dict:
    d, L, H = cfg.d_model, n_layers, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = as_torch_dtype(cfg.param_dtype)

    def head(shape, std):
        return trunc_normal((L,) + shape, std, dt, generator, device)

    return {
        "attn_norm": _ones((L, d), device),
        "mlp_norm": _ones((L, d), device),
        "wq_a": head((d, qr), d ** -0.5),
        "q_norm": _ones((L, qr), device),
        "wq_b": head((qr, H, nope + rope), qr ** -0.5),
        "wkv_a": head((d, kr + rope), d ** -0.5),
        "kv_norm": _ones((L, kr), device),
        "wkv_b": head((kr, H, nope + vh), kr ** -0.5),
        "wo": head((H, vh, d), (H * vh) ** -0.5),
        **_mlp_init(cfg, generator, device, n_layers),
    }


def _mla_qkv(cfg: ModelConfig, p: Dict, h: torch.Tensor,
             positions: torch.Tensor):
    """-> q (B,S,H,nope+rope), c_kv (B,S,kr) normed, k_rope (B,S,rope)."""
    nope = cfg.qk_nope_dim
    qa = rms_norm(dense(h, p["wq_a"]), p["q_norm"], cfg.rms_eps)
    q = proj_heads(qa, p["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    q = constrain(torch.cat([q_nope, q_rope], dim=-1), "act_q")
    kv_a = dense(h, p["wkv_a"])
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.rms_eps)
    k_rope = apply_rope(kv_a[..., cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return q, c_kv, k_rope


def apply_mla_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                    positions: torch.Tensor, collect_cache: bool = False):
    """Keys and values expanded from the latent; the attention is the
    plain one (q/k dim nope+rope, v dim v_head_dim), as in the reference.
    The cache holds the latent of all S positions (no ring)."""
    B, S, d = x.shape
    H = cfg.n_heads
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    q, c_kv, k_rope = _mla_qkv(cfg, p, h, positions)
    kv = proj_heads(c_kv, p["wkv_b"])                       # (B,S,H,nope+vh)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, rope)],
                  dim=-1)
    k = constrain(k, "act_q")
    o = attention(q, k, constrain(v, "act_q"), causal=True,
                  window=cfg.window, impl=cfg.attn_impl,
                  kv_block=cfg.kv_block, q_block=cfg.q_block,
                  scale=(nope + rope) ** -0.5, score_dtype=cfg.score_dtype)
    x = constrain(x + unproj_heads(constrain(o, "act_q"), p["wo"]),
                  "act_hidden")
    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    x = constrain(x + _mlp(cfg, p, h), "act_hidden")
    cache = None
    if collect_cache:
        cache = {"c_kv": c_kv, "k_rope": k_rope}
    return x, _no_aux(x), cache


def mla_cache_init(cfg: ModelConfig, batch: int, cache_len: int,
                   device) -> Dict:
    dt = as_torch_dtype(cfg.compute_dtype)
    return {"c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                                  dtype=dt, device=device)}


def decode_mla_block(cfg: ModelConfig, p: Dict, cache: Dict,
                     x_t: torch.Tensor, pos: int):
    """Absorbed MLA decode: attention runs in latent space, in f32 as in
    the reference; the cache is the (kv_lora_rank + rope) latent, updated
    in place."""
    B, d = x_t.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    h = rms_norm(x_t, p["attn_norm"], cfg.rms_eps)[:, None]     # (B,1,d)
    pos_b = torch.full((B, 1), pos, device=x_t.device)
    q, c_kv, k_rope = _mla_qkv(cfg, p, h, pos_b)
    q_nope, q_rope = q[..., :nope], q[..., nope:]               # (B,1,H,·)
    C = cache["c_kv"].shape[1]
    slot = pos % C
    cache = {"c_kv": constrain(_write_slot(cache["c_kv"], slot, c_kv),
                               "cache_latent"),
             "k_rope": constrain(_write_slot(cache["k_rope"], slot, k_rope),
                                 "cache_latent")}
    c_cache = cache["c_kv"].float()
    r_cache = cache["k_rope"].float()
    # absorb W_UK into q:   q_abs = q_nope @ W_UK^T  -> latent space
    w_uk = p["wkv_b"][..., :nope].float()                       # (kr,H,nope)
    w_uv = p["wkv_b"][..., nope:].float()                       # (kr,H,vh)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk)
    s = torch.einsum("bqhr,bcr->bhqc", q_abs, c_cache) + \
        torch.einsum("bqhr,bcr->bhqc", q_rope.float(), r_cache)
    s = s * (nope + rope) ** -0.5
    cpos = _cache_positions(C, pos, x_t.device)
    s = s.masked_fill(~(cpos <= pos), -1e30)
    pw = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqc,bcr->bqhr", pw, c_cache)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
    y = unproj_heads(o.to(x_t.dtype), p["wo"])[:, 0]
    x_t = x_t + y
    h2 = rms_norm(x_t, p["mlp_norm"], cfg.rms_eps)
    x_t = x_t + _mlp(cfg, p, h2)
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
    z = constrain(proj_heads(h, p["w_z"]), "act_ssm")       # (B,S,H,P)
    x_pre = constrain(proj_heads(h, p["w_x"]), "act_ssm")
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
    return constrain(x + y, "act_hidden"), _no_aux(x), cache


def ssm_cache_init(cfg: ModelConfig, batch: int, cache_len: int = 0, *,
                   device=None) -> Dict:
    """The SSM states; ``cache_len`` is the reference's and unused (the
    state does not grow with the sequence)."""
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
    x = constrain(x + fused, "act_hidden")
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    x = constrain(x + _mlp(cfg, p, h2), "act_hidden")
    cache = None
    if collect_cache:
        C = cfg.cache_len(x.shape[1])
        cache = {"k": _ring_tail(k, C), "v": _ring_tail(v, C), **ssm_cache}
    return x, _no_aux(x), cache


def hybrid_cache_init(cfg: ModelConfig, batch: int, cache_len: int,
                      device) -> Dict:
    return {**_kv_cache_init(cfg, batch, cache_len, device),
            **ssm_cache_init(cfg, batch, device=device)}


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
FAMILY_INIT = {"dense": init_dense_block, "moe": init_moe_block,
               "mla": init_mla_block, "ssm": init_ssm_block,
               "hybrid": init_hybrid_block}
FAMILY_APPLY = {"dense": apply_dense_block, "moe": apply_moe_block,
                "mla": apply_mla_block, "ssm": apply_ssm_block,
                "hybrid": apply_hybrid_block}
FAMILY_DECODE = {"dense": decode_dense_block, "moe": decode_moe_block,
                 "mla": decode_mla_block, "ssm": decode_ssm_block,
                 "hybrid": decode_hybrid_block}


def _first_layer(tree: Dict) -> Dict:
    return {k: _first_layer(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def init_block(cfg: ModelConfig, generator: torch.Generator,
               device) -> Dict:
    """One layer's params, without the leading ``n_layers`` dim."""
    return _first_layer(FAMILY_INIT[cfg.family](cfg, generator, device, 1))


def apply_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                positions: torch.Tensor, collect_cache: bool = False):
    return FAMILY_APPLY[cfg.family](cfg, p, x, positions, collect_cache)


def decode_block(cfg: ModelConfig, p: Dict, cache: Dict, x_t: torch.Tensor,
                 pos: int):
    return FAMILY_DECODE[cfg.family](cfg, p, cache, x_t, pos)


def init_layer_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    if cfg.family in ("dense", "moe"):
        return _kv_cache_init(cfg, batch, cache_len, device)
    if cfg.family == "mla":
        return mla_cache_init(cfg, batch, cache_len, device)
    if cfg.family == "ssm":
        return ssm_cache_init(cfg, batch, device=device)
    if cfg.family == "hybrid":
        return hybrid_cache_init(cfg, batch, cache_len, device)
    raise ValueError(cfg.family)
