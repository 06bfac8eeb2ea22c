"""Top-level model: embedding, the layer stack, loss, prefill, decode
(torch port of ``repro/models/model.py``, for the dense, moe, mla, ssm and
hybrid families).

Parameters are layer-stacked, as in the JAX package: every block leaf has a
leading ``n_layers`` dim, and the layers run as a loop over that dim. Param
paths, shapes and dtypes equal the JAX package's, so a checkpoint saved by
either package restores into the other. The rematerialization policy
(``cfg.remat``) wraps each layer, or under "outputs" the dense block's two
sublayers, in ``torch.utils.checkpoint``.

The LM head / CE loss is computed *chunked over the sequence*, each chunk's
logits recomputed in backward, so the full (B, S, V) logits tensor is never
held.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as tckpt

from ..sharding.ctx import constrain, settle
from .blocks import FAMILY_APPLY, FAMILY_DECODE, FAMILY_INIT, init_layer_cache
from .config import ModelConfig
from .layers import (as_torch_dtype, dense, recomputed, rms_norm, rounded,
                     trunc_normal)

LOSS_CHUNK = 512


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILY_INIT:
        raise NotImplementedError(
            f"the torch port runs the {sorted(FAMILY_INIT)} families, "
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


def param_specs(cfg: ModelConfig) -> Dict:
    """The params' tree, shapes and dtypes as meta-device tensors: nothing
    is allocated, at any width."""
    return init_params(cfg, torch.Generator(), "meta")


def lm_head_weight(cfg: ModelConfig, params: Dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _unstack(tree: Dict) -> List[Dict]:
    """Every layer of a layer-stacked subtree (blocks nest, e.g. the hybrid
    block's ``attn/`` and ``ssm/``), each leaf split once with ``unbind``:
    under autograd its backward stacks the layers' grads once, where
    indexing each layer would allocate a zero grad of the whole leaf per
    layer."""
    parts = {k: _unstack(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _layer(params: Dict, i: int) -> Dict:
    """Layer ``i`` of the blocks."""
    return _unstack(params["blocks"])[i]


# matrix products: what ``jax.checkpoint_policies.checkpoint_dots`` saves
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return tckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else tckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under the config's rematerialization policy: "none" saves
    everything, "dots" the matrix products' results, "nothing" (and any
    other value) only the block boundaries. "outputs" saves the tensors
    the JAX blocks name ``block_out``: only the dense block names them (its
    attention and MLP outputs), so there the layer runs as it is and the
    block checkpoints those two sublayers each on its own
    (``blocks._block_out``); in every other family nothing inside the
    block is named, so "outputs" saves what "nothing" saves, as JAX's
    ``save_only_these_names("block_out")`` does there."""
    if cfg.remat == "none" or (cfg.remat == "outputs"
                               and cfg.family == "dense"):
        return fn
    context_fn = tckpt.noop_context_fn
    if cfg.remat == "dots":
        context_fn = functools.partial(
            tckpt.create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return tckpt.checkpoint(fn, *args, use_reentrant=False,
                                context_fn=context_fn)
    return wrapped


def embed_tokens(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    x = torch.nn.functional.embedding(tokens, params["embed"]) \
        .to(as_torch_dtype(cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * rounded(cfg.d_model ** 0.5, x.dtype)
    if prefix_embeds is not None:
        # modality stub: precomputed patch/frame embeddings occupy the
        # first n_prefix positions
        P = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, P:]], dim=1)
    # on a mesh: a vocab-sharded lookup leaves a pending sum; settle it at
    # the residual stream's layout before any norm reads it
    return constrain(x, "act_hidden")


def backbone(cfg: ModelConfig, params: Dict, x: torch.Tensor,
             positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply all blocks. Returns (hidden, aux_loss_sum): each layer's aux
    (the moe router's load-balancing loss; zero in the other families)
    added in f32 inside the rematerialized layer, as the JAX scan carries
    it."""
    _check_family(cfg)
    apply = FAMILY_APPLY[cfg.family]

    def layer(h, aux, p):
        h, a, _ = apply(cfg, p, h, positions)
        return h, aux + a

    layer = _remat(cfg, layer)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in _unstack(params["blocks"]):
        x, aux = layer(x, aux, p)
    return rms_norm(x, params["final_norm"], cfg.rms_eps), aux


# ------------------------------------------------------------------- train
def token_loss(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Chunked cross-entropy over sequence chunks of ``LOSS_CHUNK``; padded
    vocab ids are masked to -1e30 and each chunk's logits are recomputed
    in backward, never stored."""
    B, S, d = hidden.shape
    W = lm_head_weight(cfg, params)
    Vp = W.shape[-1]
    chunk = min(LOSS_CHUNK, S)
    while S % chunk:
        chunk //= 2
    pad = torch.arange(Vp, device=hidden.device) >= cfg.vocab
    logit_dtype = as_torch_dtype(cfg.logit_dtype)

    def chunk_loss(h, l, m, W):
        logits = constrain(dense(h, W).to(logit_dtype), "logits_chunk")
        logits = logits.masked_fill(pad, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        picked = settle(torch.gather(logits, -1, l[..., None]))[..., 0]
        ce = (lse - picked) * m
        return ce.sum(), m.sum()

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(S // chunk):
        part = slice(c * chunk, (c + 1) * chunk)
        ce, n = recomputed(chunk_loss, hidden[:, part],
                           labels[:, part].long(), mask[:, part], W)
        tot = tot + ce
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B,S) int, labels (B,S) int, mask (B,S) f32, optional
    prefix_embeds (B,P,d). Returns (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_tokens(cfg, params, tokens, batch.get("prefix_embeds"))
    hidden, aux = backbone(cfg, params, x, positions)
    ce = token_loss(cfg, params, hidden, batch["labels"], batch["mask"])
    loss = ce + cfg.router_aux_coef * aux / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[Dict, torch.Tensor]:
    """Full-sequence forward that also builds the decode cache.
    ``prefix_embeds`` (B, P, d), a modality frontend's output, takes the
    first P positions.

    Returns (cache stacked over layers, last-position logits (B, vocab))."""
    _check_family(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_tokens(cfg, params, tokens, prefix_embeds)
    caches = []
    for p in _unstack(params["blocks"]):
        x, _, cache = FAMILY_APPLY[cfg.family](cfg, p, x, positions,
                                               collect_cache=True)
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
    slots by the blocks, SSM states copied in from what the block returns
    (DTensor caches, on a mesh, are rebuilt instead and the new dict
    returned). Returns (cache, logits (B, padded vocab))."""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens)
    sharded = any(isinstance(v, DTensor) for v in cache.values())
    layers = []
    for i, p in enumerate(_unstack(params["blocks"])):
        layer_cache = {k: v[i] for k, v in cache.items()}
        new, x = FAMILY_DECODE[cfg.family](cfg, p, layer_cache, x, pos)
        if sharded:         # DTensor caches come back as new tensors
            layers.append(new)
            continue
        for k, t in new.items():
            if t is not layer_cache[k]:
                cache[k][i].copy_(t)
    if sharded:
        cache = {k: torch.stack([c[k] for c in layers]) for k in cache}
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = dense(x, lm_head_weight(cfg, params)) \
        .to(as_torch_dtype(cfg.logit_dtype))
    return cache, logits

