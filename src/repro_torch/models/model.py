"""Top-level model: embedding, the layer stack, prefill, decode (torch port
of ``repro/models/model.py`` for the dense, ssm and hybrid families).

Parameters are layer-stacked, as in the JAX package: every block leaf has a
leading ``n_layers`` dim, and the layers run as a loop over that dim. Param
paths, shapes and dtypes equal the JAX package's, so a checkpoint saved by
either package restores into the other.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .blocks import FAMILY_APPLY, FAMILY_DECODE, FAMILY_INIT, init_layer_cache
from .config import ModelConfig
from .layers import as_torch_dtype, dense, rms_norm, rounded, trunc_normal


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILY_INIT:
        raise NotImplementedError(
            f"the torch port runs the {sorted(FAMILY_INIT)} families so far, "
            f"not {cfg.family!r}")


def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    """Vocab padded to a multiple of 256 (the JAX package's TP padding)."""
    return -(-cfg.vocab // multiple) * multiple


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict:
    """Random params with the JAX package's tree, shapes and dtypes, drawn
    from ``generator`` on ``device`` (a CUDA generator for a CUDA device)."""
    _check_family(cfg)
    dt = as_torch_dtype(cfg.param_dtype)
    Vp = padded_vocab(cfg)
    params = {
        "embed": trunc_normal((Vp, cfg.d_model), 1.0, dt, generator, device),
        "blocks": FAMILY_INIT[cfg.family](cfg, generator, device,
                                          cfg.n_layers),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = trunc_normal((cfg.d_model, Vp),
                                         cfg.d_model ** -0.5, dt, generator,
                                         device)
    return params


def lm_head_weight(cfg: ModelConfig, params: Dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _slice(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a layer-stacked subtree (blocks nest, e.g. the hybrid
    block's ``attn/`` and ``ssm/``)."""
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layer(params: Dict, i: int) -> Dict:
    return _slice(params["blocks"], i)


def embed_tokens(cfg: ModelConfig, params: Dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(as_torch_dtype(cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * rounded(cfg.d_model ** 0.5, x.dtype)
    return x


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor
            ) -> Tuple[Dict, torch.Tensor]:
    """Full-sequence forward that also builds the decode cache.

    Returns (cache stacked over layers, last-position logits (B, vocab))."""
    _check_family(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_tokens(cfg, params, tokens)
    caches = []
    for i in range(cfg.n_layers):
        x, cache = FAMILY_APPLY[cfg.family](cfg, _layer(params, i), x,
                                            positions, collect_cache=True)
        caches.append(cache)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = dense(x[:, -1], lm_head_weight(cfg, params)) \
        .to(as_torch_dtype(cfg.logit_dtype))
    stacked = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    return stacked, logits[:, :cfg.vocab]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Dict:
    """Zeroed decode cache stacked over layers."""
    one = init_layer_cache(cfg, batch, cfg.cache_len(cache_len), device)
    return {k: v.expand((cfg.n_layers,) + tuple(v.shape)).clone()
            for k, v in one.items()}


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[Dict, torch.Tensor]:
    """One decode step. tokens: (B,) int; pos: the position being generated,
    whose K/V enter the cache. The stacked cache is updated in place: K/V
    slots by the blocks, SSM states copied in from what the block returns.
    Returns (cache, logits (B, padded vocab))."""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens)
    for i in range(cfg.n_layers):
        layer_cache = {k: v[i] for k, v in cache.items()}
        new, x = FAMILY_DECODE[cfg.family](cfg, _layer(params, i),
                                           layer_cache, x, pos)
        for k, t in new.items():
            if t is not layer_cache[k]:
                cache[k][i].copy_(t)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = dense(x, lm_head_weight(cfg, params)) \
        .to(as_torch_dtype(cfg.logit_dtype))
    return cache, logits

