"""Serving launcher (torch port of ``repro/launch/serve.py``): restore a
checkpoint from a layered store, or draw seeded random weights, and serve
a batch of greedy requests on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
        --store /tmp/ckpt --batch 4 --prompt-len 16 --steps 16

``--device`` defaults to ``cuda``; without a card that is an error, and
``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ckpt import CheckpointManager, CheckpointPolicy
from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models import init_params
from ..models.config import ModelConfig
from ..serve import Engine, GenerationResult


def load_params(cfg: ModelConfig, store: Optional[str], device,
                seed: int = 0) -> Tuple[Dict, Optional[int]]:
    """-> (params on ``device``, restored step or None): the newest
    checkpoint in ``store``, else random weights from a seeded generator."""
    device = resolve_device(device)
    if store:
        out = CheckpointManager(store, cfg.name,
                                CheckpointPolicy()).restore(device=device)
        if out is None:
            raise SystemExit(f"no checkpoint in {store}")
        return out[0], out[2]
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, device), None


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int,
                 seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)


def serve(cfg: ModelConfig, params: Dict, prompts: np.ndarray, steps: int,
          device) -> Tuple[Engine, GenerationResult, float]:
    """Build the engine and generate; -> (engine, result, seconds)."""
    eng = Engine(cfg, params, max_len=prompts.shape[1] + steps + 8,
                 device=device)
    t0 = time.perf_counter()
    res = eng.generate(prompts, steps=steps)   # ends in a host copy
    return eng, res, time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--store", default=None,
                    help="layered checkpoint store to load weights from")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params, step = load_params(cfg, args.store, args.device, args.seed)
    if step is not None:
        print(f"[serve] loaded step-{step} from layered store")
    prompts = make_prompts(cfg, args.batch, args.prompt_len)
    _, res, dt = serve(cfg, params, prompts, args.steps, args.device)
    toks = res.tokens.size
    print(f"[serve] generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {args.device}")
    print("[serve] first sequences:", res.tokens[:2, :8].tolist())


if __name__ == "__main__":
    main()
