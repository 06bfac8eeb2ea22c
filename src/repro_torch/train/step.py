"""Step factories (torch port of ``make_train_step``,
``make_prefill_step`` and ``make_decode_step`` in ``repro/train/step.py``,
on one device).

* microbatch gradient accumulation in f32, by the reference's auto rule
  (about 2 samples a microbatch) with a data-parallel size of 1;
* the remat policy from ``ModelConfig`` (``models.model._remat``);
* gradients from autograd over the plain ops, as ``jax.value_and_grad``
  takes them over jnp.

The reference's ZeRO-1 and recipe options only place shards, so on one
device they change nothing, as on a 1x1 mesh. Its int8 gradient
compression with error feedback compresses a cross-replica reduction,
which waits for the port of ``sharding/``; asking for it raises. The
reference's bundles also carry ``in_shardings``, ``out_shardings``,
``recipe`` and ``abstract_inputs``; those wait for the same port. The
prefill and decode steps run without autograd; the decode step updates
the cache in place, as the reference's donated cache is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.layers import as_torch_dtype
from ..models.model import decode_step, init_cache, loss_fn, prefill
from ..optim import AdamWConfig, apply_update
from ..optim.adamw import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    microbatches: int = 0       # 0 = auto: target ~2 samples/device/microbatch
    zero1: bool = True
    grad_compression: Optional[str] = None     # None | "int8_ef"
    grad_reduce_dtype: Optional[str] = None    # e.g. "bfloat16": cast the
                                               # accumulated grads before the
                                               # cross-replica reduction
    recipe: Optional[str] = None               # override recipe name


@dataclass
class StepBundle:
    """A step ``fn`` and the microbatch count it runs (1 for prefill and
    decode)."""
    fn: Any
    microbatches: int = 1


def auto_microbatches(global_batch: int, dp_size: int = 1) -> int:
    """The reference's rule: a per-device microbatch of ~2 samples bounds
    saved activations."""
    per_dev = max(1, global_batch // dp_size)
    nmicro = max(1, per_dev // 2)
    while global_batch % (nmicro * dp_size) and nmicro > 1:
        nmicro -= 1
    return nmicro


def value_and_grad(cfg: ModelConfig, params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              List[torch.Tensor]]:
    """(loss, {"ce", "aux"}, grads as a list of leaves in sorted-key
    order, ``optim.adamw``'s). The params are not touched: autograd records
    through detached aliases of them."""
    aliases = tree_map(lambda v: v.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, aliases, batch)
        grads = torch.autograd.grad(loss, tree_leaves(aliases),
                                    allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        list(grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, global_batch: int,
                    seq_len: int, device=None) -> StepBundle:
    """The step for batches of ``global_batch`` x ``seq_len`` tokens on
    ``device`` (the card unless ``device="cpu"``). Batches may be numpy
    arrays or tensors; they are moved to the device. The step updates
    ``params`` and ``opt_state`` in place (see ``optim.adamw``) and
    returns them with the metrics ``loss``, ``ce``, ``aux``, ``lr`` and
    ``grad_norm`` (0-d tensors on the device; with several microbatches
    the loss and ``ce``/``aux`` are the last microbatch's, as in the
    reference)."""
    if tcfg.grad_compression is not None:
        raise NotImplementedError(
            f"grad_compression={tcfg.grad_compression!r} compresses the "
            "cross-replica gradient reduction, which waits for the port of "
            "sharding/")
    device = resolve_device(device)
    nmicro = tcfg.microbatches or auto_microbatches(global_batch)
    if global_batch % nmicro:
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{nmicro} microbatches")

    def step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        if nmicro == 1:
            loss, metrics, grads = value_and_grad(cfg, params, batch)
        else:
            grads = None
            for i in range(nmicro):
                mb = {k: v.reshape((nmicro, v.shape[0] // nmicro)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss, metrics, g = value_and_grad(cfg, params, mb)
                if grads is None:
                    grads = [torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device) for x in g]
                for acc, x in zip(grads, g):
                    acc += x
                del g
            for g in grads:
                g.div_(nmicro)
        if tcfg.grad_reduce_dtype is not None:
            rd = as_torch_dtype(tcfg.grad_reduce_dtype)
            grads = [g.to(rd) for g in grads]
        params, opt_state, stats = apply_update(tcfg.adamw, params,
                                                opt_state, grads)
        return params, opt_state, {"loss": loss, **metrics, **stats}

    return StepBundle(fn=step, microbatches=nmicro)


def _tokens(tokens, shape: Tuple[int, ...], device) -> torch.Tensor:
    t = torch.as_tensor(tokens, device=device)
    if tuple(t.shape) != shape:
        raise ValueError(f"tokens of shape {tuple(t.shape)}; the step was "
                         f"built for {shape}")
    return t.long()


def make_prefill_step(cfg: ModelConfig, global_batch: int, seq_len: int,
                      device=None) -> StepBundle:
    """``fn(params, tokens[, prefix_embeds]) -> (cache, logits)`` for
    prompts of ``global_batch`` x ``seq_len`` tokens on ``device`` (the
    card unless ``device="cpu"``): the decode cache stacked over layers,
    sized ``cfg.cache_len(seq_len)``, and the last position's logits over
    the unpadded vocab."""
    device = resolve_device(device)

    def step(params, tokens, prefix_embeds=None):
        tokens = _tokens(tokens, (global_batch, seq_len), device)
        if prefix_embeds is not None:
            prefix_embeds = torch.as_tensor(prefix_embeds, device=device)
        with torch.no_grad():
            return prefill(cfg, params, tokens, prefix_embeds)

    return StepBundle(fn=step)


def make_decode_step(cfg: ModelConfig, global_batch: int, cache_len: int,
                     device=None) -> StepBundle:
    """``fn(params, cache, tokens, pos) -> (cache, logits)``: one token
    for each of ``global_batch`` sequences at position ``pos``, against
    a cache of ``init_cache(cfg, global_batch, cache_len)``'s shapes,
    which is updated in place and returned; logits over the padded
    vocab, as the reference's."""
    device = resolve_device(device)
    want = {k: tuple(v.shape) for k, v in
            init_cache(cfg, global_batch, cache_len, "meta").items()}

    def step(params, cache, tokens, pos):
        got = {k: tuple(v.shape) for k, v in cache.items()}
        if got != want:
            raise ValueError(f"cache of shapes {got}; the step was built "
                             f"for {want}")
        tokens = _tokens(tokens, (global_batch,), device)
        with torch.no_grad():
            return decode_step(cfg, params, cache, tokens, int(pos))

    return StepBundle(fn=step)
