"""Top-level dense model: embedding, the layer stack, prefill, decode (torch
port of ``repro/models/model.py`` for the dense family).

Parameters are layer-stacked, as in the JAX package: every block leaf has a
leading ``n_layers`` dim, and the layers run as a loop over that dim. Param
paths, shapes and dtypes equal the JAX package's, so a checkpoint saved by
either package restores into the other.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .blocks import (_kv_cache_init, apply_dense_block, decode_dense_block,
                     init_dense_block)
from .config import ModelConfig
from .layers import as_torch_dtype, dense, rms_norm, rounded, trunc_normal


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the torch port runs the dense family so far, not {cfg.family!r}")


def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    """Vocab padded to a multiple of 256 (the JAX package's TP padding)."""
    return -(-cfg.vocab // multiple) * multiple


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict:
    """Random params with the JAX package's tree, shapes and dtypes, drawn
    from ``generator`` on ``device`` (a CUDA generator for a CUDA device)."""
    _check_dense(cfg)
    dt = as_torch_dtype(cfg.param_dtype)
    Vp = padded_vocab(cfg)
    params = {
        "embed": trunc_normal((Vp, cfg.d_model), 1.0, dt, generator, device),
        "blocks": init_dense_block(cfg, generator, device, cfg.n_layers),
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


def _layer(params: Dict, i: int) -> Dict:
    return {k: v[i] for k, v in params["blocks"].items()}


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
    _check_dense(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_tokens(cfg, params, tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, cache = apply_dense_block(cfg, _layer(params, i), x, positions,
                                     collect_cache=True)
        ks.append(cache["k"])
        vs.append(cache["v"])
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = dense(x[:, -1], lm_head_weight(cfg, params)) \
        .to(as_torch_dtype(cfg.logit_dtype))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}, \
        logits[:, :cfg.vocab]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Dict:
    """Zeroed decode cache stacked over layers."""
    one = _kv_cache_init(cfg, batch, cfg.cache_len(cache_len), device)
    return {k: v.expand((cfg.n_layers,) + tuple(v.shape)).clone()
            for k, v in one.items()}


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[Dict, torch.Tensor]:
    """One decode step. tokens: (B,) int; pos: the position being generated,
    whose K/V enter the cache (updated in place). Returns (cache, logits
    (B, padded vocab))."""
    _check_dense(cfg)
    x = embed_tokens(cfg, params, tokens)
    for i in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        _, x = decode_dense_block(cfg, _layer(params, i), layer_cache, x, pos)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = dense(x, lm_head_weight(cfg, params)) \
        .to(as_torch_dtype(cfg.logit_dtype))
    return cache, logits

