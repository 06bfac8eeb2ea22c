"""Sharding recipes: map (arch, shape-kind) onto a mesh (torch port of
``repro/sharding/rules.py``; the tables are the reference's entry for
entry, over the port's own ``PartitionSpec``).

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
Batch always shards over DP = ("pod","data") (or what divides); "model" is
the intra-pod axis used for TP / sequence-parallelism / cache sharding
depending on the recipe.

The functions read only the mesh's axis names and sizes: they take a
``DeviceMesh`` (``launch.mesh.make_mesh``) or any object with
``axis_names`` and a ``shape`` dict, so the tables of a 512-device mesh
need no devices. ``sharding.ctx.placements`` turns a spec into one DTensor
placement per mesh dimension.

Recipes
-------
* ``tp``      — megatron-style tensor parallelism: attention heads, FFN
                hidden, expert FFN hidden and the vocab dim shard over
                "model". Requires n_heads % model_size == 0.
* ``sp``      — sequence parallelism: activations shard their SEQUENCE dim
                over "model"; weights stay replicated over "model" except
                the (padded) vocab dim and — when divisible — FFN / expert
                hidden dims. For archs whose head counts don't divide the
                mesh (gemma 8H, granite/musicgen 24H, minicpm3 40H).
* ``dp``      — pure data parallelism over the flattened mesh (small archs:
                mamba2, hymba); ZeRO-1 shards optimizer state.
* ``tp_ssm``  — TP over the SSD head-dim P axis (divisible for P=64).
Decode recipes shard the KV/latent cache's LENGTH dim over "model"
(sequence-sharded cache) and the vocab dim for logits; batch over DP.

Optimizer state (AdamW master/m/v) is additionally sharded ZeRO-1 style
over the DP axes on the largest divisible axis of each leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

if TYPE_CHECKING:      # the models import the sharding context
    from ..models.config import ModelConfig


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (major to minor). Missing trailing entries are None. A
    one-name tuple is stored as the name, as JAX stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """axis name -> size, for a ``DeviceMesh`` (``mesh_dim_names``) or an
    object with ``axis_names`` and a ``shape`` dict (as JAX's meshes)."""
    names = tuple(mesh.axis_names if hasattr(mesh, "axis_names")
                  else mesh.mesh_dim_names)
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


Mesh = Any


@dataclass(frozen=True)
class Recipe:
    name: str                       # tp | sp | dp | tp_ssm
    kind: str                       # train | prefill | decode


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_sizes(mesh) if a in ("pod", "data"))


def model_axis(mesh: Mesh) -> str:
    return "model"


def _batch_axes_for(mesh: Mesh, batch: int,
                    include_model: bool = False) -> Tuple[str, ...]:
    """Largest prefix of DP axes (optionally + model) dividing the batch."""
    cand = dp_axes(mesh) + (("model",) if include_model else ())
    axes = []
    prod = 1
    for a in cand:
        size = mesh_sizes(mesh)[a]
        if batch % (prod * size) == 0:
            axes.append(a)
            prod *= size
    return tuple(axes)


def zero_axes_for(recipe: "Recipe", mesh: Mesh) -> Tuple[str, ...]:
    """ZeRO-1 axes: everything the params are replicated over."""
    if recipe.name == "dp":
        return dp_axes(mesh) + ("model",)
    if recipe.name == "sp":
        return dp_axes(mesh) + ("model",)   # weights replicated over model
    return dp_axes(mesh)


# ---------------------------------------------------------------- recipes
def recipe_for(cfg: ModelConfig, kind: str, mesh: Mesh) -> Recipe:
    """Baseline recipe selection (overridable via cfg.replace)."""
    m = mesh_sizes(mesh)["model"]
    if kind == "decode":
        return Recipe("decode", kind)
    if cfg.family == "ssm":
        return Recipe("tp_ssm" if (cfg.d_inner // cfg.ssm_heads) % m == 0
                      else "dp", kind)
    if cfg.family == "hybrid":
        return Recipe("dp", kind)
    if cfg.n_heads % m == 0:
        return Recipe("tp", kind)
    return Recipe("sp", kind)


# ----------------------------------------------------------- param specs
def _moe_hidden_divisible(cfg: ModelConfig, m: int) -> bool:
    return cfg.d_ff_expert % m == 0


def _moe_replicable(cfg: ModelConfig) -> bool:
    """Expert weights small enough to replicate per device (<= ~4 GB)."""
    return (cfg.n_layers * cfg.n_experts * 3 * cfg.d_model *
            cfg.d_ff_expert * 2) <= 8 << 30


def param_specs_tree(cfg: ModelConfig, recipe: Recipe, mesh: Mesh,
                     params_shape) -> Any:
    """PartitionSpec pytree matching the params tree.

    ``params_shape``: pytree of ShapeDtypeStruct (from models.param_specs).
    """
    m = mesh_sizes(mesh)["model"]
    tp = recipe.name in ("tp", "tp_sp")
    tp_ssm = recipe.name == "tp_ssm"
    sp = recipe.name == "sp"
    shard_ff = (tp or sp) and cfg.d_ff % m == 0 and cfg.d_ff > 0
    shard_fe = cfg.n_experts > 0 and _moe_hidden_divisible(cfg, m) and \
        (tp or (sp and not _moe_replicable(cfg)))
    shard_vocab = recipe.name != "dp"
    shard_heads = tp and cfg.n_heads % m == 0
    shard_kv_heads = tp and cfg.n_kv_heads % m == 0 and cfg.n_kv_heads > 0
    shard_p = (tp_ssm or (tp and cfg.has_ssm)) and cfg.ssm_heads > 0 and \
        (cfg.d_inner // cfg.ssm_heads) % m == 0

    def spec_for(path: str, ndim: int) -> P:
        def blocked(*s):
            """Prepend None for the stacked layer dim."""
            return P(*((None,) + s + (None,) * (ndim - 1 - len(s))))

        leaf = path.split("/")[-1]
        if path == "embed":
            return P("model", None) if shard_vocab else P()
        if path == "lm_head":
            return P(None, "model") if shard_vocab else P()
        if path == "final_norm":
            return P()
        # ---- blocks/* (leading dim = n_layers) ----
        if leaf in ("wq",):
            return blocked(None, "model") if shard_heads else blocked()
        if leaf in ("wk", "wv"):
            return blocked(None, "model") if shard_kv_heads else blocked()
        if leaf == "wo":
            return blocked("model") if shard_heads else blocked()
        if leaf in ("w_gate", "w_up") and cfg.n_experts > 0 and \
                "blocks" in path and ndim == 4:          # (L, E, d, fe)
            return blocked(None, None, "model") if shard_fe else blocked()
        if leaf == "w_down" and cfg.n_experts > 0 and ndim == 4:
            return blocked(None, "model") if shard_fe else blocked()
        if leaf in ("w_gate", "w_up"):                   # (L, d, ff)
            return blocked(None, "model") if shard_ff else blocked()
        if leaf == "w_down":                             # (L, ff, d)
            return blocked("model") if shard_ff else blocked()
        if leaf in ("w_z", "w_x"):                       # (L, d, H, P)
            return blocked(None, None, "model") if shard_p else blocked()
        if leaf == "conv_x_w":                           # (L, H, P, K)
            return blocked(None, "model") if shard_p else blocked()
        if leaf in ("conv_x_b", "gate_norm"):            # (L, H, P)
            return blocked(None, "model") if shard_p else blocked()
        if leaf == "out_proj":                           # (L, H, P, d)
            return blocked(None, "model") if shard_p else blocked()
        if leaf in ("wq_b", "wkv_b"):                    # (L, r, H, dh) MLA
            return blocked()
        return blocked()

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k2: walk(v, f"{path}/{k2}" if path else k2)
                    for k2, v in tree.items()}
        return spec_for(path, len(tree.shape))

    return walk(params_shape)


# ------------------------------------------------------------ batch specs
def batch_specs(cfg: ModelConfig, recipe: Recipe, mesh: Mesh,
                batch: int) -> Dict[str, P]:
    """Shardings for the input batch dict."""
    baxes = _batch_axes_for(mesh, batch, include_model=(recipe.name == "dp"))
    b = baxes if baxes else None
    specs = {"tokens": P(b, None), "labels": P(b, None),
             "mask": P(b, None)}
    if cfg.n_prefix_embeds:
        specs["prefix_embeds"] = P(b, None, None)
    return specs


# ------------------------------------------------------- activation rules
def activation_rules(cfg: ModelConfig, recipe: Recipe, mesh: Mesh,
                     batch: int) -> Dict[str, Optional[P]]:
    m = mesh_sizes(mesh)["model"]
    baxes = _batch_axes_for(mesh, batch,
                            include_model=(recipe.name == "dp"))
    b = baxes if baxes else None
    tp = recipe.name in ("tp", "tp_sp")
    sp = recipe.name == "sp"
    tp_ssm = recipe.name == "tp_ssm"
    shard_heads = tp and cfg.n_heads % m == 0
    shard_kv = tp and cfg.n_kv_heads % m == 0 and cfg.n_kv_heads > 0
    shard_ff = (tp or sp) and cfg.d_ff % m == 0 and cfg.d_ff > 0
    shard_p = (tp_ssm or (tp and cfg.has_ssm)) and cfg.ssm_heads > 0 and \
        (cfg.d_inner // cfg.ssm_heads) % m == 0

    rules: Dict[str, Optional[P]] = {}
    if recipe.kind == "decode":
        # batch over DP; cache length over model; logits vocab over model.
        rules["act_hidden"] = P(b, None)
        rules["cache_kv"] = P(b, "model", None, None)
        rules["cache_latent"] = P(b, "model", None)
        rules["logits"] = P(b, "model") if recipe.name != "dp" else P(b, None)
        return rules

    if sp:
        rules["act_hidden"] = P(b, "model", None)
        rules["act_q"] = P(b, "model", None, None)
        rules["act_kv"] = P(b, None, None, None)         # gathered for attn
        rules["act_kv_rep"] = P(b, None, None, None)
        rules["act_ffh"] = P(b, "model", None)
        rules["act_ssm"] = P(b, None, None, None)
        rules["logits_chunk"] = P(b, "model", None)
        if cfg.is_moe:
            if _moe_replicable(cfg):
                # small experts: replicate expert weights, run the MoE
                # fully shard-local (zero MoE collectives)
                rules["moe_local"] = P(b, "model", None)
            else:
                # gather tokens over "model" for local routing; expert
                # FFN hidden stays TP-sharded; output reduce-scatters.
                rules["act_moe_in"] = P(b, None, None)
                rules["act_moe_out"] = P(b, "model", None)
    elif tp or tp_ssm:
        # tp_sp: Megatron-SP — the residual stream (and so every norm /
        # elementwise fusion between blocks) is sequence-sharded over
        # "model"; XLA pairs the surrounding collectives as RS+AG.
        rules["act_hidden"] = P(b, "model", None) \
            if recipe.name == "tp_sp" else P(b, None, None)
        if recipe.name == "tp_sp":
            rules["act_block_in"] = P(b, None, None)   # the SP gather
        rules["act_q"] = P(b, None, "model", None) if shard_heads else None
        rules["act_kv"] = P(b, None, "model", None) if shard_kv else \
            (P(b, None, None, None) if tp else None)
        rules["act_kv_rep"] = P(b, None, "model", None) if shard_heads \
            else None
        rules["act_ffh"] = P(b, None, "model") if shard_ff else None
        rules["act_ssm"] = P(b, None, None, "model") if shard_p else None
        rules["logits_chunk"] = P(b, None, "model")
    else:  # dp
        rules["act_hidden"] = P(b, None, None)
        rules["logits_chunk"] = P(b, None, None)
    return rules


# ------------------------------------------------------------ cache specs
def cache_specs(cfg: ModelConfig, recipe: Recipe, mesh: Mesh,
                batch: int, cache_shape) -> Any:
    """PartitionSpec tree for the (layer-stacked) decode cache."""
    baxes = _batch_axes_for(mesh, batch)
    b = baxes if baxes else None

    def spec(path: str, ndim: int) -> P:
        leaf = path.split("/")[-1]
        if leaf in ("k", "v"):                   # (L, B, C, KVH, D)
            return P(None, b, "model", None, None)
        if leaf in ("c_kv", "k_rope"):           # (L, B, C, r)
            return P(None, b, "model", None)
        if leaf in ("conv_x", "conv_B", "conv_C"):   # (L, B, K-1, ...)
            return P(None, b)
        if leaf == "h":                          # (L, B, H, P, N)
            return P(None, b)
        return P(None, b)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k2: walk(v, f"{path}/{k2}" if path else k2)
                    for k2, v in tree.items()}
        return spec(path, len(tree.shape))

    return walk(cache_shape)


# -------------------------------------------------------------- optimizer
def opt_specs(param_spec_tree, params_shape, mesh: Mesh,
              zero_axes: Tuple[str, ...]) -> Any:
    """ZeRO-1: shard each optimizer leaf over zero_axes on its largest
    axis that (a) is unsharded in the param spec and (b) divides evenly."""
    def one(spec: P, shape) -> P:
        entries = list(spec) + [None] * (len(shape.shape) - len(spec))
        used = set()
        for e in entries:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    used.add(a)
        axes = tuple(a for a in zero_axes if a not in used)
        if not axes:
            return spec
        n = math.prod(mesh_sizes(mesh)[a] for a in axes)
        if n <= 1:
            return spec
        # choose the largest unsharded, divisible axis
        best, best_size = None, 0
        for i, (s, dim) in enumerate(zip(entries, shape.shape)):
            if s is None and dim % n == 0 and dim > best_size:
                best, best_size = i, dim
        if best is None:
            return spec
        entries[best] = axes if len(axes) > 1 else axes[0]
        return P(*entries)

    def walk(specs, shapes):
        if isinstance(specs, dict):
            return {k: walk(specs[k], shapes[k]) for k in specs}
        return one(specs, shapes)

    return walk(param_spec_tree, params_shape)
