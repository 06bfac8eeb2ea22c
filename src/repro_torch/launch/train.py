"""Training launcher (torch port of ``repro/launch/train.py``): one device,
the deterministic data pipeline, incremental (code-injection)
checkpointing and restore-and-resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 50 --batch 8 --seq 64 --ckpt /tmp/ckpt

``--device`` defaults to ``cuda``; without a card that is an error, and
``--device cpu`` runs on the CPU. A run with ``--ckpt`` resumes from the
newest checkpoint there, and the batches of the steps it runs are those
of an uninterrupted run. ``--watchdog-s`` arms ``ft.Watchdog`` around
each step, which prints ``[watchdog] step hung`` when a step outlasts it.
Meshes other than 1x1 wait for the port of ``sharding/`` and raise.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..ckpt import CheckpointManager, CheckpointPolicy
from ..configs import get_config, get_smoke_config
from ..data import SyntheticTokens
from ..device import resolve_device
from ..ft import Watchdog
from ..models import init_params
from ..optim import AdamWConfig, init_opt_state
from ..train import TrainConfig, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; only 1x1 is ported")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--incremental", action="store_true", default=True)
    ap.add_argument("--full-ckpt", dest="incremental", action="store_false")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--watchdog-s", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training waits for the port of "
            "sharding/; only 1x1 runs")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(adamw=AdamWConfig(peak_lr=args.lr,
                                         decay_steps=max(args.steps, 10)))

    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    opt = init_opt_state(params)
    start_step = 0
    mgr = None
    if args.ckpt:
        mgr = CheckpointManager(
            args.ckpt, cfg.name,
            CheckpointPolicy(every_steps=args.ckpt_every,
                             incremental=args.incremental,
                             async_write=True))
        restored = mgr.restore(device=device)
        if restored is not None:
            params, opt, start_step = restored
            print(f"[train] resumed from step {start_step}")

    ds = SyntheticTokens(cfg.vocab, batch=args.batch, seq=args.seq)
    bundle = make_train_step(cfg, tcfg, args.batch, args.seq, device)
    wd = Watchdog(args.watchdog_s, lambda: print("[watchdog] step hung")) \
        if args.watchdog_s > 0 else None
    t0 = time.perf_counter()
    for s in range(start_step, args.steps):
        if wd:
            wd.arm()
        params, opt, metrics = bundle.fn(params, opt, ds.batch_at(s))
        if wd:
            wd.disarm()
        if (s + 1) % max(1, args.steps // 20) == 0 or s == start_step:
            print(f"[train] step {s + 1}: loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if mgr and (s + 1) % args.ckpt_every == 0:
            mgr.save(s + 1, params, opt)
    if mgr:
        mgr.wait()
    dt = time.perf_counter() - t0
    n_steps = args.steps - start_step
    print(f"[train] {n_steps} steps in {dt:.1f}s "
          f"({dt / max(n_steps, 1) * 1e3:.1f} ms/step) on {device}")


if __name__ == "__main__":
    main()
