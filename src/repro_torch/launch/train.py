"""Training launcher (torch port of ``repro/launch/train.py``): a
``DeviceMesh``, the sharded train step, the deterministic data pipeline
(``make_global_batch``), incremental (code-injection) checkpointing and
restore-and-resume onto the mesh (``reshard_restore``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 50 --batch 8 --seq 64 --ckpt /tmp/ckpt
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch yi-6b --smoke --mesh 2x1 \\
        --device cpu --ckpt /tmp/ckpt

``--device`` defaults to ``cuda``; without a card that is an error, and
``--device cpu`` runs on the CPU. A run with ``--ckpt`` resumes from the
newest checkpoint there, and the batches of the steps it runs are those
of an uninterrupted run. ``--watchdog-s`` arms ``ft.Watchdog`` around
each step, which prints ``[watchdog] step hung`` when a step outlasts it.

``--mesh DxM`` lays the run over D*M ranks: under ``torchrun`` (its
environment names the rank and the world) the world must be D*M, and each
rank uses ``cuda:<local rank>`` (NCCL) or the CPU (gloo). Without that
environment only ``--mesh 1x1`` runs, on a single-rank mesh. Rank 0 prints
and writes the checkpoints; every rank takes part in their gathers.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time

import torch
import torch.distributed as dist

from ..ckpt import CheckpointManager, CheckpointPolicy, reshard_restore
from ..configs import get_config, get_smoke_config
from ..data import SyntheticTokens, make_global_batch
from ..device import resolve_device
from ..ft import Watchdog
from ..models import init_params
from ..optim import AdamWConfig, init_opt_state
from ..sharding import spec_tree
from ..train import TrainConfig, make_train_step
from .mesh import make_mesh

_GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def _join_world(device: torch.device, n: int) -> None:
    """Join the group that ``torchrun``'s environment describes; its world
    must be the mesh's ``n`` ranks."""
    if "RANK" not in os.environ or dist.is_initialized():
        return
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise ValueError(f"the mesh has {n} devices; torchrun started "
                         f"{world} ranks")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=_GROUP_TIMEOUT)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--incremental", action="store_true", default=True)
    ap.add_argument("--full-ckpt", dest="incremental", action="store_false")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--watchdog-s", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    d, m = (int(x) for x in args.mesh.split("x"))
    _join_world(device, d * m)
    mesh = make_mesh((d, m), ("data", "model"), device)
    rank0 = dist.get_rank() == 0
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(adamw=AdamWConfig(peak_lr=args.lr,
                                         decay_steps=max(args.steps, 10)))
    bundle = make_train_step(cfg, tcfg, args.batch, args.seq, mesh=mesh)
    pspec, ospec, bspec = (spec_tree(t) for t in bundle.in_shardings)

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
        restored = reshard_restore(mgr, mesh, pspec, ospec)
        if restored is not None:
            params, opt, start_step = restored
            if rank0:
                print(f"[train] resumed from step {start_step}")

    ds = SyntheticTokens(cfg.vocab, batch=args.batch, seq=args.seq)
    wd = Watchdog(args.watchdog_s, lambda: print("[watchdog] step hung")) \
        if args.watchdog_s > 0 else None
    t0 = time.perf_counter()
    for s in range(start_step, args.steps):
        batch = make_global_batch(mesh, bspec, ds.batch_at(s))
        if wd:
            wd.arm()
        params, opt, metrics = bundle.fn(params, opt, batch)
        if wd:
            wd.disarm()
        if rank0 and ((s + 1) % max(1, args.steps // 20) == 0
                      or s == start_step):
            print(f"[train] step {s + 1}: loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if mgr and (s + 1) % args.ckpt_every == 0:
            mgr.save(s + 1, params, opt)
    if mgr:
        mgr.wait()
    dt = time.perf_counter() - t0
    n_steps = args.steps - start_step
    if rank0:
        print(f"[train] {n_steps} steps in {dt:.1f}s "
              f"({dt / max(n_steps, 1) * 1e3:.1f} ms/step) on {device}, "
              f"mesh {args.mesh}")


if __name__ == "__main__":
    main()
