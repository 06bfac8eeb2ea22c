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
from torch.distributed.tensor.experimental import local_map

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
            with _replicating():
                yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def _replicating():
    """DTensor's ``implicit_replication``, restoring the flag it found on
    exit (torch's sets it to False, which would end an enclosing one: a
    recompute's context inside the step's)."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def in_current_ctx(fn):
    """``fn`` bound to the rules and mesh in force now. A checkpointed body
    is recomputed in backward, which autograd runs on a thread of its own
    for CUDA tensors (fake ones too), where this thread's context is not
    seen: unbound, the recompute would skip every ``constrain`` and lay
    its activations out otherwise than the forward did."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    def bound(*args, **kwargs):
        if _CTX.get() is ctx:
            return fn(*args, **kwargs)
        with activation_ctx(*ctx):
            return fn(*args, **kwargs)
    return bound


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    rules, _ = ctx
    spec = rules.get(name)
    return x if spec is None else at_spec(x, spec)


def at_spec(x: DTensor, spec: PartitionSpec) -> DTensor:
    """``x`` at ``spec``'s placements on its own mesh: ``x`` itself where
    it lies so already, else redistributed (pending sums reduced first)."""
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


def local_block(shape, mesh, placements_) -> Tuple[Tuple[int, ...],
                                                    Tuple[int, ...]]:
    """(local shape, global offset) of this rank's block of a tensor of
    global ``shape`` at ``placements_``, cut as DTensor cuts it: each
    ``Shard(d)``, in mesh-dim order, splits dim d into chunks of
    ceil(n / k) with the tail chunks short or empty (``torch.chunk``), so
    uneven splits are right. Reads only the mesh coordinate, never tensor
    values, so it runs on fake tensors too."""
    size, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            n, k = size[p.dim], mesh.size(i)
            chunk = -(-n // k)
            start = min(chunk * coord[i], n)
            size[p.dim] = min(n, start + chunk) - start
            offset[p.dim] += start
    return tuple(size), tuple(offset)


def _chunk_bounds(n: int, k: int):
    """[start, end) of each of ``k`` blocks of a dim of ``n`` cut as
    DTensor cuts it (``torch.chunk``: blocks of ceil(n / k), the tail
    ones short or empty)."""
    c = -(-n // k)
    return [(min(c * i, n), min(c * (i + 1), n)) for i in range(k)]


def narrow_sharded(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """``x.narrow(dim, 0, length)``, keeping a DTensor that is sharded on
    ``dim`` over one mesh dim sharded there (the reference's
    ``logits[:, :vocab]`` on vocab-sharded logits stays sharded).
    DTensor cuts a dim at ``torch.chunk``'s boundaries, which move when the
    dim shrinks, and its own slice of a sharded dim gathers the whole dim
    to every rank. Here each rank sends the others only the entries of its
    block that fall in theirs (one all-to-all over that mesh dim, where XLA
    issues a collective-permute) and keeps its own. Plain tensors, and any
    other layout, take ``narrow``."""
    if not isinstance(x, DTensor):
        return x.narrow(dim, 0, length)
    if length == x.shape[dim]:
        return x
    on = [i for i, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim == dim]
    if len(on) != 1 or type(x.placements[on[0]]) is not Shard or \
            any(p.is_partial() for p in x.placements):
        return x.narrow(dim, 0, length)
    from torch.distributed import _functional_collectives as funcol
    mesh, md = x.device_mesh, on[0]
    k, r = mesh.size(md), mesh.get_local_rank(md)
    old, new = _chunk_bounds(x.shape[dim], k), _chunk_bounds(length, k)

    def overlap(a, b):
        return max(0, min(a[1], b[1]) - max(a[0], b[0]))

    local = x.to_local().movedim(dim, 0)
    base = old[r][0]
    pieces = []
    for j in range(k):      # this rank's entries that rank j's block takes
        lo = max(old[r][0], new[j][0])
        pieces.append(local[lo - base:lo - base + overlap(old[r], new[j])])
    if any(overlap(old[i], new[j]) for i in range(k) for j in range(k)
           if i != j):
        send = [n if j != r else 0 for j, n in enumerate(
            overlap(old[r], new[j]) for j in range(k))]
        recv = [n if j != r else 0 for j, n in enumerate(
            overlap(old[j], new[r]) for j in range(k))]
        got = funcol.all_to_all_single(
            torch.cat([p for j, p in enumerate(pieces) if j != r])
            .contiguous(), recv, send, mesh.get_group(md))
        parts = list(torch.split(funcol.wait_tensor(got), recv))
        parts[r] = pieces[r]
    else:
        parts = [pieces[r]]
    block = torch.cat(parts).movedim(0, dim).contiguous()
    shape = list(x.shape)
    shape[dim] = length
    return DTensor.from_local(block, mesh, x.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


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
