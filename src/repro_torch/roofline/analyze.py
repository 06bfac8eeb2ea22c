"""Roofline terms of one traced step (torch port of
``repro/roofline/analyze.py``).

    compute term    = per-device FLOPs / peak FLOP/s
    memory term     = per-device bytes / HBM bandwidth
    collective term = per-device collective bytes / link bandwidth

The reference takes the per-device totals from the compiled, partitioned
HLO of a step; the port counts them while rank 0 runs the step
(``count.Counter``). For evenly sharded programs every rank does rank 0's
work, so dividing by one card's peak equals global / (devices x peak).

Hardware constants: one NVIDIA H100 SXM5 (NVIDIA's data sheet, dense
rates): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, and
450 GB/s a direction over NVLink 4. A 16-wide mesh axis spans two 8-GPU
nodes, whose link between them is slower than NVLink, so the one
``link_bw`` term is optimistic across nodes, as the reference's single ICI
term is across pods.

The reference's ``xla_cost_flops`` and ``xla_cost_bytes`` (XLA's own
``cost_analysis``) have no counterpart: nothing compiles the step. In
their place a result carries ``by_op``, the counter's calls, FLOPs and
bytes by operation.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict

from .count import Counter, tensor_bytes


@dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12        # bf16 dense, tensor cores
    hbm_bw: float = 3.35e12           # B/s, HBM3
    link_bw: float = 450e9            # B/s a direction, NVLink 4


def collective_bytes(coll: Dict[str, float]) -> Dict[str, float]:
    """The counter's result bytes by kind -> the same with 'total', the
    wire-bytes estimate (all-reduce counted twice: a ring all-reduce moves
    about twice its payload)."""
    out = dict(coll)
    out["total"] = sum(v * (2.0 if k == "all-reduce" else 1.0)
                       for k, v in coll.items())
    return out


@dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    recipe: str = ""
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    arg_bytes: float = 0.0
    temp_bytes: float = 0.0
    out_bytes: float = 0.0
    model_flops: float = 0.0          # 6*N*D (or active) global
    n_devices: int = 0
    compile_seconds: float = 0.0      # the port: seconds to trace the step

    def terms(self, hw: HW = HW()) -> Dict[str, float]:
        t_compute = self.flops_per_device / hw.peak_flops
        t_memory = self.bytes_per_device / hw.hbm_bw
        t_coll = self.coll_bytes.get("total", 0.0) / hw.link_bw
        dom = max((t_compute, "compute"), (t_memory, "memory"),
                  (t_coll, "collective"))[1]
        useful = self.model_flops / max(self.flops_per_device *
                                        self.n_devices, 1.0)
        bound = max(t_compute, t_memory, t_coll)
        # roofline fraction: useful-compute time over the achievable step
        # time bound (what fraction of the machine the model math uses)
        frac = (self.model_flops / (self.n_devices * hw.peak_flops)) \
            / bound if bound > 0 else 0.0
        return {"compute_s": t_compute, "memory_s": t_memory,
                "collective_s": t_coll, "dominant": dom,
                "useful_flops_ratio": useful, "roofline_fraction": frac}

    def to_json(self) -> dict:
        d = self.__dict__.copy()
        d["terms"] = self.terms()
        return d


def _local(tree):
    """DTensor leaves as their local shards (what this rank holds)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_local(v) for v in tree]
    return tree.to_local() if isinstance(tree, DTensor) else tree


def analyze_step(fn, args, *, arch: str, shape: str, mesh_name: str,
                 recipe: str, model_flops: float, n_devices: int,
                 trace_seconds: float = 0.0) -> CellResult:
    """``fn(*args)`` run once under ``count.Counter`` -> its ``CellResult``.

    ``args`` may be real tensors or fake ones (``FakeTensorMode``, entered
    by the caller), DTensors or plain. ``arg_bytes`` and ``out_bytes`` are
    the local bytes of the inputs and the outputs; ``temp_bytes`` is the
    peak of the bytes held by storages the step allocated while it ran
    (its outputs among them), the counter's ``peak_bytes``, where the
    reference reads XLA's ``memory_analysis``. ``compile_seconds`` is
    ``trace_seconds`` (the caller's set-up) plus the wall time of the
    counted call; ``by_op`` is set beside the fields."""
    arg_bytes = tensor_bytes(_local(list(args)))
    t0 = time.perf_counter()
    with Counter() as counter:
        out = fn(*args)
    seconds = trace_seconds + time.perf_counter() - t0
    t = counter.totals
    res = CellResult(arch=arch, shape=shape, mesh=mesh_name, recipe=recipe,
                     flops_per_device=t.flops, bytes_per_device=t.bytes,
                     coll_bytes=collective_bytes(t.coll),
                     arg_bytes=float(arg_bytes),
                     temp_bytes=float(counter.peak_bytes),
                     out_bytes=float(tensor_bytes(_local(
                         list(out) if isinstance(out, tuple) else out))),
                     model_flops=model_flops, n_devices=n_devices,
                     compile_seconds=seconds)
    res.by_op = {k: list(v) for k, v in sorted(counter.by_op.items())}
    return res


def roofline_terms(result: CellResult, hw: HW = HW()) -> Dict[str, float]:
    return result.terms(hw)
