"""Quickstart on the PyTorch port: train a small model end to end with
incremental (code injection) checkpointing, then serve it; the loop of
``examples/quickstart.py`` through ``repro_torch``'s public API.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--save-every", type=int, default=40)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config("yi-6b").replace(n_layers=4)
    print(f"arch={cfg.name} (reduced) params={cfg.param_count() / 1e6:.2f}M "
          f"on {device}")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    opt = init_opt_state(params)
    acfg = AdamWConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=200,
                       weight_decay=0.0)
    # one microbatch a step, as the reference's jitted value_and_grad
    step = make_train_step(cfg, TrainConfig(adamw=acfg, microbatches=1),
                           args.batch, args.seq, device).fn

    ckpt_dir = tempfile.mkdtemp(prefix="lc_quickstart_torch_")
    try:
        mgr = CheckpointManager(ckpt_dir, cfg.name,
                                CheckpointPolicy(incremental=True,
                                                 async_write=False))
        ds = SyntheticTokens(cfg.vocab, batch=args.batch, seq=args.seq,
                             seed=0)
        for s in range(args.steps):
            params, opt, metrics = step(params, opt, ds.batch_at(s))
            if s % 20 == 0:
                print(f"step {s:4d}  loss {float(metrics['loss']):.4f}")
            if (s + 1) % args.save_every == 0:
                rep = mgr.save(s + 1, params, opt)
                print(f"  [ckpt] step {s + 1}: "
                      f"injected={rep.layers_injected} "
                      f"rekeyed={rep.layers_rekeyed} "
                      f"bytes={rep.bytes_serialized / 1e6:.1f}MB "
                      f"({rep.wall_seconds * 1e3:.0f}ms)")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    print("\nserving greedy samples from the trained weights:")
    eng = Engine(cfg, params, max_len=96, device=device)
    prompts = ds.batch_at(0)["tokens"][:2, :16]
    res = eng.generate(prompts, steps=12)
    print("generated:", res.tokens.tolist())
    print("quickstart OK")


if __name__ == "__main__":
    main()
