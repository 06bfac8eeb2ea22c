"""AdamW with f32 master weights (torch port of ``repro/optim/adamw.py``).

Params live in bf16 (compute); the optimizer carries an f32 master copy and
f32 moments. The state tree is the reference's, ``{"step", "master", "m",
"v"}`` with ``step`` a 0-d int32 tensor, so the checkpoint's ``opt_state``
layer holds the same records. The schedule and the bias corrections are
computed in f32 tensors, as XLA computes them.

``apply_update`` writes master, m, v, step and the params IN PLACE (the JAX
step donates its inputs; in place keeps the device at 16 bytes a parameter
with the grads) and returns the same trees. A caller that must keep the
state of a step, such as an asynchronous save, copies it first
(``CheckpointManager.save`` does).

Over DTensor trees (a train step on a mesh) each leaf keeps its placements:
the params at their recipe's, master/m/v at the optimizer's (ZeRO-1:
``sharding.rules.opt_specs`` shards them over the axes the params are
replicated on). The grads are reduced to the optimizer's placements (a
reduce-scatter where ZeRO-1 shards), the global norm is taken over the
full tensors, and each new master is cast to its param's dtype and then
gathered back to the param's placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) *
                         0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the order of sorted keys, as ``jax.tree.leaves`` gives a
    dict's (a list's in its order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params) -> Dict[str, Any]:
    """f32 copies (never aliases, for f32 leaves too) and zero moments, on
    the params' devices."""
    some = tree_leaves(params)[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=some.device),
            "master": tree_map(lambda a: a.detach().to(torch.float32, copy=True),
                           params),
            "m": tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                            device=a.device), params),
            "v": tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                            device=a.device), params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(a.to(torch.float32)))
                          for a in tree_leaves(tree)))


@torch.no_grad()
def apply_update(cfg: AdamWConfig, params, opt_state, grads
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping, in place (see the module
    docstring). ``grads`` is a tree like ``params`` or a list of its
    leaves in ``tree_leaves`` order. Returns (params, opt_state, {"lr",
    "grad_norm"})."""
    opt_state["step"] += 1
    step = opt_state["step"].to(torch.float32)
    lr = lr_at(cfg, opt_state["step"])
    flat_g = [_reduced_to(g, master) for g, master in
              zip(tree_leaves(grads), tree_leaves(opt_state["master"]))]
    gnorm = global_norm(flat_g)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step)
    bc2 = 1 - torch.pow(b2, step)
    for p, master, m, v, g in zip(tree_leaves(params),
                                  tree_leaves(opt_state["master"]),
                                  tree_leaves(opt_state["m"]),
                                  tree_leaves(opt_state["v"]), flat_g):
        g = g.to(torch.float32) * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        mh, vh = m / bc1, v / bc2
        master.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps) +
                          cfg.weight_decay * master))
        if isinstance(p, DTensor):
            p.copy_(master.to(p.dtype).redistribute(p.device_mesh,
                                                    p.placements))
        else:
            p.copy_(master)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


def _reduced_to(g: torch.Tensor, master: torch.Tensor) -> torch.Tensor:
    """A DTensor grad (pending sums over the batch axes, a param's
    placements) reduced to its optimizer leaf's placements."""
    if not isinstance(g, DTensor):
        return g
    return g.redistribute(master.device_mesh, master.placements)
