"""Plain training reference: autograd through the family's float32
forward, the mean token cross-entropy, and AdamW with global-norm
clipping, bias corrections and a linear-warmup cosine schedule, on float32
weights started from the served ones.

``follow`` takes the same batches the system under test trained on and
returns what the check compares: each step's loss on the last microbatch's
rows (the rows the system reports its loss on), each leaf's norm of the
first step's clipped gradient, and each leaf's norm of the weights' change
after the steps.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from .common import exact_f32, flatten, unflatten


def lr_at(a: dict, step: int) -> float:
    if step < a["warmup_steps"]:
        return a["peak_lr"] * step / max(a["warmup_steps"], 1)
    prog = min(max((step - a["warmup_steps"]) /
                   max(a["decay_steps"] - a["warmup_steps"], 1), 0.0), 1.0)
    return a["peak_lr"] * (a["min_lr_ratio"] + (1 - a["min_lr_ratio"]) *
                           0.5 * (1 + math.cos(math.pi * prog)))


def _loss(family, c: dict, w: dict, tokens, labels, mask, precision):
    h = family.hidden(c, w, tokens, precision)
    logits = family.logits(c, w, h, precision)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return ((lse - picked) * mask).sum() / mask.sum().clamp(min=1.0)


def follow(family, c: dict, weights: dict, batches: Sequence[dict],
           adamw: dict, microbatches: int, device, precision: str = "f32",
           fault: str = "") -> Dict[str, object]:
    """``weights``: the served tree the run started from; ``batches``:
    the first steps' host batches (tokens, labels, mask). ``fault``
    "half_batch" leaves out the second half of every microbatch's rows."""
    init = {k: v.detach().float().clone() for k, v in flatten(weights).items()}
    p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in init.items()}
    v_ = {k: torch.zeros_like(v) for k, v in init.items()}
    names = sorted(p)
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    with exact_f32():
        for step, batch in enumerate(batches, start=1):
            arr = {k: torch.as_tensor(np.asarray(x), device=device)
                   for k, x in batch.items()}
            B = arr["tokens"].shape[0]
            rows = B // microbatches
            grads = {k: torch.zeros_like(x) for k, x in init.items()}
            for i in range(microbatches):
                sl = slice(i * rows, (i + 1) * rows if fault != "half_batch"
                           else i * rows + rows // 2)
                tree = unflatten(p)
                loss = _loss(family, c, tree, arr["tokens"][sl].long(),
                             arr["labels"][sl].long(), arr["mask"][sl].float(),
                             precision)
                g = torch.autograd.grad(loss, [p[k] for k in names])
                for k, gk in zip(names, g):
                    grads[k] += gk / microbatches
                del tree, g
            losses.append(float(loss.detach()))
            with torch.no_grad():
                gnorm = math.sqrt(sum(float((g * g).sum())
                                      for g in grads.values()))
                scale = min(adamw["grad_clip"] / (gnorm + 1e-9), 1.0)
                lr = lr_at(adamw, step)
                b1, b2 = adamw["b1"], adamw["b2"]
                for k in names:
                    g = grads[k] * scale
                    if step == 1:
                        first_grad[k] = float(g.norm())
                    m[k].mul_(b1).add_((1 - b1) * g)
                    v_[k].mul_(b2).add_((1 - b2) * g * g)
                    mh = m[k] / (1 - b1 ** step)
                    vh = v_[k] / (1 - b2 ** step)
                    p[k].sub_(lr * (mh / (vh.sqrt() + adamw["eps"]) +
                                    adamw["weight_decay"] * p[k]))
    change = {k: float((p[k].detach() - init[k]).norm()) for k in names}
    return {"loss": losses, "grad_norm": first_grad, "change_norm": change}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              moved: Sequence[str]) -> Dict[str, float]:
    """Each moved leaf's |program norm - reference norm| over the larger
    of the reference's norm of that leaf and of the median leaf."""
    med = float(np.median([reference[k] for k in moved]))
    return {k: abs(program[k] - reference[k]) / max(reference[k], med)
            for k in moved}


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   moved: Sequence[str]) -> float:
    return max(leaf_gaps(program, reference, moved).values())


def moved_leaves(first_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's."""
    med = float(np.median(list(first_grad.values())))
    return sorted(k for k, g in first_grad.items() if g >= 1e-3 * med)
