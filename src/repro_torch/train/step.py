"""Step factories (torch port of ``make_train_step``,
``make_prefill_step`` and ``make_decode_step`` in ``repro/train/step.py``).

With ``mesh=None`` a step runs on one device. With a ``DeviceMesh``
(``launch.mesh.make_mesh``) the factory resolves the sharding recipe for
(arch, shape-kind, mesh), computes the PartitionSpecs of params, optimizer
state, batch and cache, and runs the step on DTensors at their placements
under the recipe's activation rules (``sharding.activation_ctx``); the
bundle carries the shardings, the recipe and the abstract inputs (meta
tensors), as the reference's does for its dry-run.

* microbatch gradient accumulation in f32, by the reference's auto rule
  (about 2 samples a device a microbatch, with the DP size of the batch
  spec); microbatch i is rows [i*B/n, (i+1)*B/n) of the GLOBAL batch, as
  the reference's reshape makes it (on a mesh the batch is laid out so
  once a step, ``_microbatches``);
* the remat policy from ``ModelConfig`` (``models.model._remat``);
* ZeRO-1 (``tcfg.zero1``): master, m and v sharded over the axes the params
  are replicated on (``optim.adamw`` reduces the grads to them);
* ``grad_reduce_dtype`` casts the accumulated grads before their reduction;
* gradients from autograd over the plain ops, as ``jax.value_and_grad``
  takes them over jnp.

``TrainConfig.grad_compression`` is accepted and read nowhere, as in the
reference: the step trains uncompressed (``optim.compression`` holds the
int8 all-reduce for a caller that runs it). The prefill and decode steps
run without autograd; the decode step updates the cache in place, as the
reference's donated cache is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..data.pipeline import make_global_batch
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.layers import as_torch_dtype
from ..models.model import (decode_step, init_cache, loss_fn, param_specs,
                            prefill)
from ..optim import AdamWConfig, apply_update
from ..optim.adamw import tree_leaves, tree_map
from ..sharding.ctx import (NamedSharding, activation_ctx, at_spec,
                            from_full, full_tree, shard_tree, spec_axes)
from ..sharding.rules import (PartitionSpec as P, Recipe, activation_rules,
                              batch_specs, cache_specs, mesh_sizes,
                              opt_specs, param_specs_tree, recipe_for,
                              zero_axes_for)


@dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    microbatches: int = 0       # 0 = auto: target ~2 samples/device/microbatch
    zero1: bool = True
    grad_compression: Optional[str] = None     # None | "int8_ef"; read
                                               # nowhere, as in the reference
    grad_reduce_dtype: Optional[str] = None    # e.g. "bfloat16": cast the
                                               # accumulated grads before the
                                               # cross-replica reduction
    recipe: Optional[str] = None               # override recipe name


@dataclass
class StepBundle:
    """A step ``fn`` and the microbatch count it runs (1 for prefill and
    decode). On a mesh: the ``NamedSharding`` trees of its inputs and
    outputs, its ``Recipe``; ``abstract_inputs`` holds meta tensors of the
    params (and optimizer state or cache) it takes."""
    fn: Any
    microbatches: int = 1
    in_shardings: Any = None
    out_shardings: Any = None
    recipe: Optional[Recipe] = None
    abstract_inputs: Any = None


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


def _named(mesh, spec_tree):
    if isinstance(spec_tree, dict):
        return {k: _named(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, spec_tree)


def _dp_size(mesh, bspec) -> int:
    size = 1
    for a in spec_axes(bspec["tokens"][0]):
        size *= mesh_sizes(mesh)[a]
    return size


def _opt_spec_tree(pspec, pshape, mesh, zero_axes):
    ospec = opt_specs(pspec, pshape, mesh, zero_axes)
    return {"step": P(), "master": ospec, "m": ospec, "v": ospec}


def _abstract_opt_state(pshape):
    f32 = tree_map(lambda a: torch.empty(a.shape, dtype=torch.float32,
                                         device="meta"), pshape)
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "master": f32, "m": f32, "v": f32}


def _microbatches(batch: Dict[str, torch.Tensor], nmicro: int):
    """The batch laid out once as (nmicro, B/nmicro, ...), as the
    reference's reshape makes it: microbatch i is rows [i*B/n, (i+1)*B/n)
    of the GLOBAL batch. A DTensor batch is gathered once a step and cut
    again with its batch shards moved to dim 1, so that each
    microbatch's rows stay on the data axes and indexing one (``[i]``)
    moves nothing. (DTensor cannot split a sharded dim into (n, B/n) when
    the mesh does not divide n, as 8 microbatches over 16 data ranks.)"""
    out = {}
    for k, v in batch.items():
        shape = (nmicro, v.shape[0] // nmicro) + tuple(v.shape[1:])
        if not isinstance(v, DTensor):
            out[k] = v.reshape(shape)
            continue
        mesh = v.device_mesh
        whole = v.redistribute(mesh, [Replicate()] * mesh.ndim)
        out[k] = whole.reshape(shape).redistribute(mesh, [
            Shard(p.dim + 1) if isinstance(p, Shard) else p
            for p in v.placements])
    return out


def _f32_zeros(x: torch.Tensor) -> torch.Tensor:
    """An f32 accumulator for grads like ``x``; for a DTensor, at ``x``'s
    placements (pending sums stay pending until the optimizer reduces)."""
    if isinstance(x, DTensor):
        return DTensor.from_local(
            torch.zeros_like(x.to_local(), dtype=torch.float32),
            x.device_mesh, x.placements)
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, global_batch: int,
                    seq_len: int, device=None, mesh=None) -> StepBundle:
    """The step for batches of ``global_batch`` x ``seq_len`` tokens.

    ``mesh=None``: on ``device`` (the card unless ``device="cpu"``).
    Batches may be numpy arrays or tensors; they are moved to the device.

    With a ``DeviceMesh``: params, optimizer state and batch are DTensors
    at the bundle's ``in_shardings``; plain trees (the full state, which
    every rank holds) and host batches are laid out on the first call
    (``sharding.shard_tree``, ``data.make_global_batch``) and the
    returned trees are the DTensor ones. The metrics come back as full
    tensors on every rank.

    The step updates ``params`` and ``opt_state`` in place (see
    ``optim.adamw``) and returns them with the metrics ``loss``, ``ce``,
    ``aux``, ``lr`` and ``grad_norm`` (0-d tensors on the device; with
    several microbatches the loss and ``ce``/``aux`` are the last
    microbatch's, as in the reference)."""
    recipe = arules = None
    pshape = param_specs(cfg)
    abstract = (pshape, _abstract_opt_state(pshape), None)
    in_sh = out_sh = None
    if mesh is None:
        device = resolve_device(device)
        dp_size = 1
    else:
        recipe = recipe_for(cfg, "train", mesh)
        if tcfg.recipe:
            recipe = Recipe(tcfg.recipe, "train")
        pspec = param_specs_tree(cfg, recipe, mesh, pshape)
        zero_axes = zero_axes_for(recipe, mesh) if tcfg.zero1 else ()
        ospec = _opt_spec_tree(pspec, pshape, mesh, zero_axes)
        bspec = batch_specs(cfg, recipe, mesh, global_batch)
        arules = activation_rules(cfg, recipe, mesh, global_batch)
        dp_size = _dp_size(mesh, bspec)
        in_sh = (_named(mesh, pspec), _named(mesh, ospec),
                 _named(mesh, bspec))
        out_sh = (in_sh[0], in_sh[1], None)
    nmicro = tcfg.microbatches or auto_microbatches(global_batch, dp_size)
    if global_batch % nmicro:
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{nmicro} microbatches")

    def grads_of(params, batch):
        if nmicro == 1:
            return value_and_grad(cfg, params, batch)
        grads = None
        mbs = _microbatches(batch, nmicro)
        for i in range(nmicro):
            loss, metrics, g = value_and_grad(
                cfg, params, {k: v[i] for k, v in mbs.items()})
            if grads is None:
                grads = [_f32_zeros(x) for x in g]
            for acc, x in zip(grads, g):
                acc += x
            del g
        for g in grads:
            g.div_(nmicro)
        return loss, metrics, grads

    def update(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        if tcfg.grad_reduce_dtype is not None:
            rd = as_torch_dtype(tcfg.grad_reduce_dtype)
            grads = [g.to(rd) for g in grads]
        params, opt_state, stats = apply_update(tcfg.adamw, params,
                                                opt_state, grads)
        return params, opt_state, {"loss": loss, **metrics, **stats}

    def step(params, opt_state, batch):
        if mesh is None:
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()}
            return update(params, opt_state, batch)
        params = shard_tree(params, mesh, pspec)
        opt_state = shard_tree(opt_state, mesh, ospec)
        if not all(isinstance(v, DTensor) for v in batch.values()):
            batch = make_global_batch(mesh, bspec, batch)
        with activation_ctx(arules, mesh):
            params, opt_state, metrics = update(params, opt_state, batch)
        return params, opt_state, full_tree(metrics)

    return StepBundle(fn=step, microbatches=nmicro, in_shardings=in_sh,
                      out_shardings=out_sh, recipe=recipe,
                      abstract_inputs=abstract)


def _tokens(tokens, shape: Tuple[int, ...], device) -> torch.Tensor:
    t = torch.as_tensor(tokens, device=device)
    if tuple(t.shape) != shape:
        raise ValueError(f"tokens of shape {tuple(t.shape)}; the step was "
                         f"built for {shape}")
    return t.long()


def _logits_spec(recipe: Recipe, bspec) -> P:
    """Where a meshed step leaves its logits (B, vocab): the batch as the
    tokens lie, the vocab over "model" as the lm head shards it, except
    under "dp", whose batch takes "model" too (the reference's decode rule
    ``logits``, and what its prefill's partitioner gives)."""
    return P(bspec[0], "model") if recipe.name != "dp" else P(bspec[0], None)


def _place_tokens(tokens, shape, mesh, spec) -> DTensor:
    if isinstance(tokens, DTensor):
        return from_full(tokens, mesh, spec)
    return from_full(_tokens(tokens, shape, "cpu"), mesh, spec)


def make_prefill_step(cfg: ModelConfig, global_batch: int, seq_len: int,
                      device=None, mesh=None,
                      recipe_name: Optional[str] = None) -> StepBundle:
    """``fn(params, tokens[, prefix_embeds]) -> (cache, logits)`` for
    prompts of ``global_batch`` x ``seq_len`` tokens on ``device`` (the
    card unless ``device="cpu"``): the decode cache stacked over layers,
    sized ``cfg.cache_len(seq_len)``, and the last position's logits over
    the unpadded vocab.

    With a ``DeviceMesh``: the prefill recipe (or ``recipe_name``) lays out
    params and tokens (plain inputs are laid out on the call), the cache
    comes back as DTensors at the decode cache's specs, and the logits as
    the DTensor the step computed, at ``out_shardings[1]``: batch as the
    tokens, vocab over "model" (batch only under "dp"); a caller that
    needs the whole tensor calls ``full_tensor()``."""
    pshape = param_specs(cfg)
    recipe = in_sh = out_sh = None
    if mesh is None:
        device = resolve_device(device)
    else:
        recipe = recipe_for(cfg, "prefill", mesh)
        if recipe_name:
            recipe = Recipe(recipe_name, "prefill")
        pspec = param_specs_tree(cfg, recipe, mesh, pshape)
        bspec = batch_specs(cfg, recipe, mesh, global_batch)
        arules = activation_rules(cfg, recipe, mesh, global_batch)
        cspec = cache_specs(cfg, Recipe("decode", "decode"), mesh,
                            global_batch,
                            init_cache(cfg, global_batch, seq_len, "meta"))
        in_sh = [_named(mesh, pspec), _named(mesh, bspec["tokens"])]
        if cfg.n_prefix_embeds:
            in_sh.append(_named(mesh, bspec["prefix_embeds"]))
        lspec = _logits_spec(recipe, bspec["tokens"])
        in_sh, out_sh = tuple(in_sh), (_named(mesh, cspec),
                                       _named(mesh, lspec))

    def step(params, tokens, prefix_embeds=None):
        if mesh is None:
            tokens = _tokens(tokens, (global_batch, seq_len), device)
            if prefix_embeds is not None:
                prefix_embeds = torch.as_tensor(prefix_embeds, device=device)
            with torch.no_grad():
                return prefill(cfg, params, tokens, prefix_embeds)
        params = shard_tree(params, mesh, pspec)
        tokens = _place_tokens(tokens, (global_batch, seq_len), mesh,
                               bspec["tokens"])
        if prefix_embeds is not None:
            prefix_embeds = from_full(torch.as_tensor(prefix_embeds), mesh,
                                      bspec["prefix_embeds"])
        with activation_ctx(arules, mesh), torch.no_grad():
            cache, logits = prefill(cfg, params, tokens, prefix_embeds)
        return shard_tree(cache, mesh, cspec), at_spec(logits, lspec)

    return StepBundle(fn=step, in_shardings=in_sh, out_shardings=out_sh,
                      recipe=recipe, abstract_inputs=(pshape,))


def make_decode_step(cfg: ModelConfig, global_batch: int, cache_len: int,
                     device=None, mesh=None,
                     recipe_name: Optional[str] = None) -> StepBundle:
    """``fn(params, cache, tokens, pos) -> (cache, logits)``: one token
    for each of ``global_batch`` sequences at position ``pos``, against
    a cache of ``init_cache(cfg, global_batch, cache_len)``'s shapes,
    which is updated in place and returned; logits over the padded
    vocab, as the reference's.

    With a ``DeviceMesh``: params at the train recipe's placements (as the
    reference places decode weights), the cache at the decode recipe's
    (``recipe_name`` or "decode"; plain inputs are laid out on the call),
    and the logits as the DTensor the step computed, at the recipe's
    ``logits`` rule (``out_shardings[1]``: vocab over "model", batch over
    the batch axes; batch only under "dp"); a caller that needs the whole
    tensor calls ``full_tensor()``."""
    pshape = param_specs(cfg)
    cshape = init_cache(cfg, global_batch, cache_len, "meta")
    want = {k: tuple(v.shape) for k, v in cshape.items()}
    recipe = in_sh = out_sh = None
    if mesh is None:
        device = resolve_device(device)
    else:
        recipe = Recipe(recipe_name or "decode", "decode")
        pspec = param_specs_tree(cfg, recipe_for(cfg, "train", mesh), mesh,
                                 pshape)
        cspec = cache_specs(cfg, recipe, mesh, global_batch, cshape)
        arules = activation_rules(cfg, recipe, mesh, global_batch)
        tspec = P(batch_specs(cfg, recipe, mesh, global_batch)["tokens"][0])
        in_sh = (_named(mesh, pspec), _named(mesh, cspec),
                 _named(mesh, tspec), _named(mesh, P()))
        lspec = arules["logits"]
        out_sh = (in_sh[1], _named(mesh, lspec))

    def step(params, cache, tokens, pos):
        got = {k: tuple(v.shape) for k, v in cache.items()}
        if got != want:
            raise ValueError(f"cache of shapes {got}; the step was built "
                             f"for {want}")
        if mesh is None:
            tokens = _tokens(tokens, (global_batch,), device)
            with torch.no_grad():
                return decode_step(cfg, params, cache, tokens, int(pos))
        params = shard_tree(params, mesh, pspec)
        cache = shard_tree(cache, mesh, cspec)
        tokens = _place_tokens(tokens, (global_batch,), mesh, tspec)
        with activation_ctx(arules, mesh), torch.no_grad():
            cache, logits = decode_step(cfg, params, cache, tokens, int(pos))
        return shard_tree(cache, mesh, cspec), at_spec(logits, lspec)

    return StepBundle(fn=step, in_shardings=in_sh, out_shardings=out_sh,
                      recipe=recipe, abstract_inputs=(pshape, cshape))
