"""Per-device FLOPs, bytes and collectives of one step, counted from the
operations the torch dispatcher runs (torch port of
``repro/roofline/hlo_parse.py``).

The reference walks the optimized, partitioned HLO of a compiled step and
multiplies loop bodies by their trip counts. An eager torch step has no
such program to parse: its Python runs every loop, layer and microbatch,
and each operation passes through the dispatcher once for each time it
runs. So ``Counter``, a ``TorchDispatchMode``, counts what rank 0 does,
operation by operation, and no trip count is needed:

* FLOPs -- the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``)
  through ``torch.utils.flop_counter.flop_registry``: 2 x result x
  contraction, as ``_dot_flops`` counts a ``dot``. Elementwise operations
  are ignored, as there. No arch of the registry has a convolution (the
  SSM's causal conv is a sum of shifted products), so none is counted.
* bytes -- the eager traffic model, a deviation: the reference counts
  XLA's post-fusion traffic, the port counts what eager PyTorch moves,
  unfused, so its memory term is larger. A materializing operation reads
  its tensor operands and writes its results; views and metadata move
  nothing; gathers that copy (``index_select``, ``gather``, ``embedding``,
  ``index.Tensor``) count 2 x their result, as ``dynamic-slice`` is
  counted there; updates of a region (``index_put_``, the ``scatter``
  family, ``index_add``/``index_copy``, ``slice_scatter``,
  ``select_scatter``, ``copy_``) count 2 x the update, as
  ``dynamic-update-slice`` is.
* collectives -- result bytes by kind ("all-reduce", "all-gather",
  "reduce-scatter", "all-to-all"), for the functional collectives DTensor
  issues (``_c10d_functional``) and the c10d ones
  ``torch.distributed.nn.functional`` issues; ``Totals.coll_wire_bytes``
  counts all-reduce twice, as ``collective_bytes`` does. A collective's
  result bytes also count as bytes, as there; ``wait_tensor`` moves
  nothing.

On DTensors the mode steps aside (it returns ``NotImplemented``) so that
DTensor's own dispatch runs the operation: the local operations and the
collectives that dispatch issues then come back through the mode, which
counts them. DTensor's sharding propagator, the first time it meets an
(operation, placements, shapes) case, also runs the operation once at its
GLOBAL shape on fake tensors of the same device, to learn the output's
metadata; and DTensor computes the offsets of strided shards (a sharded
dim flattened with another) from index tensors. Neither is rank 0's work,
so the counter skips whatever runs inside
``ShardingPropagator._propagate_tensor_meta_non_cached`` and
``_StridedShard.local_shard_size_and_offset``. It also runs them with any
``FakeTensorMode`` set aside: the offsets are read with ``.tolist()``,
which a fake index tensor cannot answer (the propagator makes a fake mode
of its own for the global-shape call).

The counter also keeps the peak of the bytes held by the storages that
operations allocate during the count (``peak_bytes``; views and in-place
updates allocate nothing), and each operation's share (``by_op``).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

aten = torch.ops.aten

_DOTS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
# allocation and metadata: nothing moves (views are found by their schema)
_NO_TRAFFIC = {"_unsafe_view", "empty", "empty_like", "empty_strided",
               "new_empty", "new_empty_strided", "lift_fresh", "device",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
               "wait_tensor"}
_GATHERS = {"index_select", "gather", "embedding", "index"}
# region updates -> the schema argument that holds the update
_UPDATES = {"index_put_": "values", "index_put": "values",
            "_index_put_impl_": "values", "scatter": "src",
            "scatter_": "src", "scatter_add": "src", "scatter_add_": "src",
            "scatter_reduce": "src", "scatter_reduce_": "src",
            "index_add": "source", "index_add_": "source",
            "index_copy": "source", "index_copy_": "source",
            "slice_scatter": "src", "select_scatter": "src", "copy_": "src"}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d")


@dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Totals", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v * mult

    @property
    def coll_wire_bytes(self) -> float:
        total = 0.0
        for k, v in self.coll.items():
            total += v * (2.0 if k.startswith("all-reduce") else 1.0)
        return total


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tensor_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (lists, tuples, dicts)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _named_args(func, args, kwargs) -> Dict[str, object]:
    out = dict(kwargs)
    for a, v in zip(func._schema.arguments, args):
        out[a.name] = v
    return out


def _update_bytes(func, name: str, args, kwargs) -> float:
    named = _named_args(func, args, kwargs)
    upd = named.get(_UPDATES[name])
    if isinstance(upd, torch.Tensor):
        return 2.0 * upd.numel() * upd.element_size()
    # a scalar written at every index (scatter.value)
    return 2.0 * named["index"].numel() * named["self"].element_size()


class Counter(TorchDispatchMode):
    """``with Counter() as c: step(...)`` -> ``c.totals`` (rank 0's FLOPs,
    bytes and collective bytes by kind), ``c.by_op`` (operation name ->
    [calls, FLOPs, bytes]) and ``c.peak_bytes``. Enter it inside any
    ``FakeTensorMode`` so that it sees operations first."""

    def __init__(self):
        super().__init__()
        self.totals = Totals()
        self.by_op: Dict[str, List[float]] = {}
        self.peak_bytes = 0
        self._live_bytes = 0
        self._live = WeakIdKeyDictionary()
        self._shadow = 0
        self._unpatch = None

    # ---- DTensor's layout bookkeeping is not rank 0's work
    def __enter__(self):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard
        meta = "_propagate_tensor_meta_non_cached"
        if meta not in ShardingPropagator.__dict__:
            raise RuntimeError(
                f"torch {torch.__version__}: ShardingPropagator has no {meta}; "
                "the counter cannot tell DTensor's sharding propagation from "
                "rank 0's operations")
        counter = self
        undo = []

        def shadow(owner, name):
            orig = owner.__dict__[name]

            def shadowed(*a, **kw):
                counter._shadow += 1
                try:
                    with unset_fake_temporarily():
                        return orig(*a, **kw)
                finally:
                    counter._shadow -= 1
            setattr(owner, name, shadowed)
            undo.append(lambda: setattr(owner, name, orig))

        shadow(ShardingPropagator, meta)
        if "local_shard_size_and_offset" in _StridedShard.__dict__:
            shadow(_StridedShard, "local_shard_size_and_offset")
        self._unpatch = lambda: [u() for u in undo]
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    # ---- the count
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._shadow:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        flops = nbytes = 0.0
        if packet in _DOTS:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        ns = func.namespace
        if ns in _COLL_NAMESPACES and name in _COLLECTIVES:
            nbytes = float(tensor_bytes(out))
            kind = _COLLECTIVES[name]
            self.totals.coll[kind] = self.totals.coll.get(kind, 0.0) + nbytes
        elif func.is_view or name in _NO_TRAFFIC:
            pass
        elif name in _GATHERS and ns == "aten":
            nbytes = 2.0 * tensor_bytes(out)
        elif name in _UPDATES and ns == "aten":
            nbytes = _update_bytes(func, name, args, kwargs)
        else:
            nbytes = float(tensor_bytes((args, kwargs)) + tensor_bytes(out))
        self.totals.flops += flops
        self.totals.bytes += nbytes
        rec = self.by_op.setdefault(f"{ns}.{name}", [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        if not (func.is_view or func._schema.is_mutable):
            self._track(out)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._live:
                continue
            n = st.nbytes()
            self._live[st] = n
            self._live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)
            weakref.finalize(st, _freed, weakref.ref(self), n)


def _freed(counter_ref, n: int) -> None:
    counter = counter_ref()
    if counter is not None:
        counter._live_bytes -= n
