"""The paper's sweet spot in a training workflow, on the PyTorch port:
prompt tuning, where each step touches a tiny, EARLY slice of the state
(8 soft-prompt embedding rows) and the backbone stays frozen. The
Docker-baseline checkpointer re-serializes every layer below the change;
injection writes only the changed chunks and re-keys the rest. The
walkthrough of ``examples/finetune_lora_ckpt.py`` through ``repro_torch``.

    PYTHONPATH=src python examples/finetune_lora_ckpt_torch.py               # card
    PYTHONPATH=src python examples/finetune_lora_ckpt_torch.py --device cpu
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_update, init_opt_state  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

N_SOFT = 8
STEPS = 8


def config():
    return get_smoke_config("gemma-2b").replace(n_layers=4, d_model=128,
                                                d_ff=256, vocab=4096)


def finetune(cfg, params, device):
    """Tune the first ``N_SOFT`` embedding rows of ``params`` for ``STEPS``
    steps twice, saving every step, once with full and once with
    incremental saves. -> {mode: [each save's BuildReport]}."""
    # trainable = 8 soft-prompt embedding rows; backbone frozen. The
    # embedding is the FIRST content layer of the checkpoint image, so
    # the Docker-baseline save falls through everything below it.
    acfg = AdamWConfig(peak_lr=1e-2, warmup_steps=5, decay_steps=100,
                       weight_decay=0.0)
    frozen = dict(params)
    trainable = {"soft": params["embed"][:N_SOFT].clone()}
    opt = init_opt_state(trainable)

    def assemble(t):
        p = dict(frozen)
        p["embed"] = torch.cat([t["soft"].to(frozen["embed"].dtype),
                                frozen["embed"][N_SOFT:]], dim=0)
        return p

    def step(t, o, batch):
        soft = t["soft"].detach().requires_grad_(True)
        with torch.enable_grad():
            loss, _ = loss_fn(cfg, assemble({"soft": soft}), batch)
            (grad,) = torch.autograd.grad(loss, [soft])
        t, o, _ = apply_update(acfg, t, o, [grad])
        return t, o, loss.detach()

    ds = SyntheticTokens(cfg.vocab, batch=8, seq=64, seed=1)
    reports = {}
    for mode in ("full", "incremental"):
        ckpt_dir = tempfile.mkdtemp(prefix=f"lc_lora_torch_{mode}_")
        try:
            mgr = CheckpointManager(
                ckpt_dir, cfg.name,
                CheckpointPolicy(incremental=(mode == "incremental"),
                                 async_write=False, chunk_bytes=16 << 10))
            # each mode tunes from the same start (the update is in place)
            t = tree_map(torch.clone, trainable)
            o = tree_map(torch.clone, opt)
            mgr.save(0, assemble(t), {"step": torch.zeros((), dtype=torch.int32)})
            reports[mode] = []
            for s in range(STEPS):
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in ds.batch_at(s).items()}
                t, o, _ = step(t, o, batch)
                reports[mode].append(mgr.save(
                    s + 1, assemble(t),
                    {"step": torch.tensor(s + 1, dtype=torch.int32)}))
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    total_mb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(params)) / 1e6
    print(f"backbone: {total_mb:.1f} MB; tuning {N_SOFT} soft-prompt "
          "embedding rows (prompt-tuning), backbone frozen")
    results = {}
    for mode, reps in finetune(cfg, params, device).items():
        results[mode] = (np.mean([r.bytes_serialized for r in reps]),
                         np.mean([r.wall_seconds * 1e3 for r in reps]))
        print(f"{mode:12s}: {results[mode][0] / 1e6:8.2f} MB/save, "
              f"{results[mode][1]:7.1f} ms/save")
    speed = results["full"][1] / results["incremental"][1]
    shrink = results["full"][0] / max(results["incremental"][0], 1)
    print(f"\nincremental injection: {speed:.0f}x faster, "
          f"{shrink:.0f}x fewer bytes per checkpoint")
    assert results["incremental"][0] < results["full"][0] / 10
    print("finetune_lora_ckpt OK")


if __name__ == "__main__":
    main()
