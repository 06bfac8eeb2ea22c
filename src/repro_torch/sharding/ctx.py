"""Activation-sharding context (torch port of ``repro/sharding/ctx.py``).

Model code is written once, distribution-agnostic. Inside a step function
the launcher installs a rule table (name -> PartitionSpec) and its mesh;
``constrain`` then redistributes a named DTensor activation to the rule's
placements, as the reference pins it with ``with_sharding_constraint``.
Outside any context, or on a plain tensor (unit tests, CPU examples, one
device), it is a no-op.

A ``PartitionSpec`` becomes one DTensor placement per mesh dimension
(``placements``): ``Shard(d)`` on every mesh dimension that tensor dim
``d`` names, ``Replicate()`` elsewhere. DTensor's dispatch then inserts the
collectives that XLA's partitioner inserts. Inside a context with a mesh,
plain tensors that meet DTensors (positions, masks, zero accumulators) are
taken as replicated (``implicit_replication``): the model makes them at
their global shapes.

``local_call`` stands in for ``shard_map``: it runs a body on each rank's
local shards.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from .rules import PartitionSpec, mesh_sizes

_CTX: contextvars.ContextVar[Optional[Tuple[Dict, object]]] = \
    contextvars.ContextVar("activation_rules", default=None)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: Optional[PartitionSpec], ndim: int):
    """The DTensor placements of ``spec`` on ``mesh`` for a tensor of rank
    ``ndim``. A dim sharded over several axes must name them in mesh
    order: DTensor shards them in that order, major to minor, as the
    reference's tuple does. An axis of size 1 splits nothing and stays
    ``Replicate`` (DTensor refuses some views of a dim "sharded" over
    one device, such as flattening a single KV head)."""
    sizes = mesh_sizes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(tuple(spec or ())[:ndim]):
        axes = spec_axes(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in dims:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    if len(tuple(spec or ())) > ndim and any(tuple(spec)[ndim:]):
        raise ValueError(f"spec {spec} is longer than a rank-{ndim} tensor")
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec


def shard_index(sizes: Dict[str, int], coord: Dict[str, int],
                spec: Optional[PartitionSpec], shape) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` that the device at mesh position
    ``coord`` (axis -> index) holds under ``spec``: each dim is cut into
    equal parts over its axes, major to minor (the reference's
    ``NamedSharding.devices_indices_map``). A dim that its axes do not
    divide raises: DTensor would cut it unevenly where JAX pads."""
    out = []
    entries = tuple(spec or ())
    for d, n_d in enumerate(shape):
        axes = spec_axes(entries[d]) if d < len(entries) else ()
        n, idx = 1, 0
        for a in axes:
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        if n_d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {axes} ({n} parts)")
        part = n_d // n
        out.append(slice(idx * part, (idx + 1) * part))
    return tuple(out)


def spec_tree(shardings):
    """The PartitionSpecs of a tree of ``NamedSharding`` (a step bundle's
    ``in_shardings[i]``), for ``shard_tree`` or ``reshard_restore``."""
    if isinstance(shardings, dict):
        return {k: spec_tree(v) for k, v in shardings.items()}
    return shardings.spec


def _coord(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def from_full(t: torch.Tensor, mesh, spec: Optional[PartitionSpec]
              ) -> DTensor:
    """A DTensor at ``spec``'s placements from the full tensor ``t`` that
    this rank holds: it keeps only its own block (``shard_index``), with
    no communication. A DTensor ``t`` is redistributed instead."""
    pl = placements(mesh, spec, t.ndim)
    if isinstance(t, DTensor):
        return settle(t).redistribute(mesh, pl)
    t = t.to(torch.device(mesh.device_type, _device_index(mesh)))
    idx = shard_index(mesh_sizes(mesh), _coord(mesh), spec, t.shape)
    local = t[idx]
    if local.numel() != t.numel():
        local = local.clone()         # free the rest of the full tensor
    return DTensor.from_local(local, mesh, pl)


def _device_index(mesh):
    return torch.cuda.current_device() if mesh.device_type == "cuda" \
        else None


def shard_tree(tree, mesh, spec_tree):
    """``from_full`` on every leaf of a (nested dict) tree, each with the
    spec at its path in ``spec_tree``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, mesh, spec_tree[k]) for k, v in tree.items()}
    return from_full(tree, mesh, spec_tree)


def full_tree(tree):
    """Every DTensor leaf gathered into its full tensor (a collective: every
    rank of its mesh takes part); plain leaves as they are."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def current_mesh():
    """The mesh of the enclosing ``activation_ctx`` (None outside one)."""
    ctx = _CTX.get()
    return ctx[1] if ctx is not None else None


def current_rules() -> Dict:
    ctx = _CTX.get()
    return ctx[0] if ctx is not None else {}


@contextlib.contextmanager
def activation_ctx(rules: Dict[str, Optional[PartitionSpec]], mesh=None):
    """Install ``rules`` (and the ``mesh`` they shard over) for the body."""
    token = _CTX.set((rules, mesh))
    try:
        if mesh is None:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _CTX.reset(token)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    rules, _ = ctx
    spec = rules.get(name)
    if spec is None:
        return x
    want = placements(x.device_mesh, spec, x.ndim)
    if tuple(x.placements) == tuple(want):
        return x
    return settle(x).redistribute(x.device_mesh, want)


def settle(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every pending sum over a mesh dimension reduced (a
    vocab-sharded lookup leaves a mask-partial one, which DTensor cannot
    reduce-scatter); a plain tensor is returned as it is."""
    if not isinstance(x, DTensor) or \
            not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def partial_over(mesh, spec: PartitionSpec, ndim: int):
    """Placements of a replicated operand whose local gradients, taken on
    the shards of a tensor laid out by ``spec``, must be summed over the
    mesh dims that ``spec`` shards (the transpose of ``shard_map``'s
    unmapped input)."""
    sharded = {i for i, p in enumerate(placements(mesh, spec, ndim))
               if isinstance(p, Shard)}
    return [Partial() if i in sharded else Replicate()
            for i in range(len(mesh_sizes(mesh)))]


def local_call(fn, mesh, out_placements, in_placements: Sequence,
               in_grad_placements: Optional[Sequence] = None):
    """``fn`` run on each rank's local shards (the reference's
    ``shard_map``): DTensor arguments are redistributed to
    ``in_placements``, ``fn`` sees their local tensors, and its results are
    DTensors at ``out_placements``. ``in_grad_placements`` gives the layout
    of each argument's gradient (``partial_over`` for replicated operands
    that the body reads on token shards)."""
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(tuple(in_grad_placements)
                                         if in_grad_placements else None),
                     device_mesh=mesh, redistribute_inputs=True)
