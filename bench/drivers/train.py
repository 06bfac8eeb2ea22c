"""Training: ``make_train_step`` on batches drawn from the seed, no saves.

Mix parameters: ``batch`` x ``seq`` tokens a step, ``microbatches`` (0:
the step's own rule), ``adamw`` (the optimizer's settings), and
``checked_steps``: the steps, from the seed's weights, that set-up drives
through the window's own call and that the reference follows after the
window.

The first steps' numbers are read before the window: each step's loss,
each leaf's norm of the first step's gradient as the optimizer got it
(its first moment over 1 - b1), and each leaf's norm of the change of the
optimizer's float32 weights after the checked steps, as the first step
of the window finds them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import sync
from ..reference.common import flatten
from ..reference.train import follow, leaf_gaps, moved_leaves


def batch_at(ctx, step: int) -> dict:
    """Rows of tokens drawn from the seed; every step's rows differ."""
    B, S = ctx.mix["batch"], ctx.mix["seq"]
    toks = ctx.rng(5, step).integers(0, ctx.cfg.vocab, (B, S + 1),
                                     dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy(),
            "mask": np.ones((B, S), np.float32)}


def run(ctx) -> None:
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    mix, cfg = ctx.mix, ctx.cfg
    B, S = mix["batch"], mix["seq"]
    adamw = mix["adamw"]
    params = ctx.weights()
    init = {k: v.clone() for k, v in flatten(params).items()}
    opt = init_opt_state(params)
    bundle = make_train_step(cfg, TrainConfig(
        adamw=AdamWConfig(**adamw), microbatches=mix["microbatches"]),
        B, S, device=ctx.device)
    checked = mix["checked_steps"]
    losses, first_grad = [], {}
    for step in range(checked):
        params, opt, met = bundle.fn(params, opt, batch_at(ctx, step))
        losses.append(met["loss"])
        if step == 0:
            first_grad = {k: (m / (1 - adamw["b1"])).norm()
                          for k, m in flatten(opt["m"]).items()}
    change = {k: (m - init[k].float()).norm()
              for k, m in flatten(opt["master"]).items()}
    del init
    sync(ctx.device)
    step = checked
    with ctx.open_window() as win:
        while win.remaining() > 0:
            ctx.attempted += 1
            with ctx.rec.span("train_step"):
                params, opt, met = bundle.fn(params, opt, batch_at(ctx, step))
                sync(ctx.device)
            step += 1
    done = step - checked
    ctx.rec.add("steps", done)
    ctx.rec.add("train_flops", done * ctx.flops.train_flops(ctx.config, B, S))
    ctx.report("train_tokens_per_s", done * B * S / win.seconds)
    losses = [float(x) for x in losses]
    first_grad = {k: float(v) for k, v in first_grad.items()}
    change = {k: float(v) for k, v in change.items()}
    if not np.isfinite(float(met["loss"])):
        ctx.failed += 1
    nmicro = bundle.microbatches
    del params, opt, bundle, met
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    start = ctx.weights()
    batches = [batch_at(ctx, s) for s in range(checked)]
    ref = follow(ctx.family, ctx.config, start, batches, adamw, nmicro,
                 ctx.device)
    moved = moved_leaves(ref["grad_norm"])
    _judge(ctx.check, losses, first_grad, change, ref, moved, ctx.note)
    for mode in ctx.modes:
        other = follow(ctx.family, ctx.config, start, batches, adamw, nmicro,
                       ctx.device, precision="fp8" if mode == "control"
                       else "f32", fault="" if mode == "control" else mode)
        _judge(lambda n, v: ctx.reading(mode, n, v), other["loss"],
               other["grad_norm"], other["change_norm"], ref, moved)


def _judge(put, losses, first_grad, change, ref, moved, note=None) -> None:
    """The numbers compared: the worst step's loss gap, and the worst
    leaf's gaps of the first gradient's and the change's norms. The
    change's worst leaf swings from seed to seed (Adam's steps on
    elements whose gradient is round-off sized), so the median leaf's
    change gap, which is steady, is compared as well."""
    put("loss_gap", max(abs(a - b) / abs(b)
                        for a, b in zip(losses, ref["loss"])))
    for name, prog, want in (("first_grad_norm_gap", first_grad,
                              ref["grad_norm"]),
                             ("weight_change_norm_gap", change,
                              ref["change_norm"])):
        gaps = leaf_gaps(prog, want, moved)
        worst = max(gaps, key=gaps.get)
        put(name, gaps[worst])
        if note is not None:
            note(name + ".worst_leaf", worst)
    put("weight_change_median_gap",
        float(np.median(list(leaf_gaps(change, ref["change_norm"],
                                       moved).values()))))
