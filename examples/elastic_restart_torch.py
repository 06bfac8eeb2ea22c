"""Fault tolerance walkthrough on the PyTorch port: train, kill mid-run,
restore from the layered store and continue, bit-identical to an
uninterrupted run; then the elastic re-mesh choice after losing devices
and the straggler skipper. The walkthrough of ``examples/elastic_restart.py``
through ``repro_torch``'s public API, on one device (a resharded restore
waits for the port of ``sharding/``).

    PYTHONPATH=src python examples/elastic_restart_torch.py               # card
    PYTHONPATH=src python examples/elastic_restart_torch.py --device cpu
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
from repro_torch.ft import DeadlineSkipper, shrink_mesh_shape  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402

BATCH, SEQ = 8, 32


def config():
    """-> (model config, AdamW config) of the walkthrough."""
    cfg = get_smoke_config("musicgen-medium").replace(n_layers=3)
    acfg = AdamWConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=100,
                       weight_decay=0.0)
    return cfg, acfg


def run(cfg, acfg, init, steps, device, start=0, state=None, mgr=None,
        save_every=5):
    """Train steps ``start``..``steps - 1`` from ``state`` (params, opt), or
    from ``init()``'s params with a fresh optimizer, saving every
    ``save_every`` steps to ``mgr``. -> (params, opt, losses)."""
    ds = SyntheticTokens(cfg.vocab, batch=BATCH, seq=SEQ, seed=2)
    # one microbatch a step, as the reference's jitted value_and_grad
    step = make_train_step(cfg, TrainConfig(adamw=acfg, microbatches=1),
                           BATCH, SEQ, device).fn
    if state is None:
        params = init()
        opt = init_opt_state(params)
    else:
        params, opt = state
    losses = []
    for s in range(start, steps):
        params, opt, metrics = step(params, opt, ds.batch_at(s))
        losses.append(float(metrics["loss"]))
        if mgr and (s + 1) % save_every == 0:
            mgr.save(s + 1, params, opt)
    if mgr:
        mgr.wait()
    return params, opt, losses


def crash_and_restore(cfg, acfg, init, device, root):
    """Run A: 10 uninterrupted steps. Run B: 5 steps and a save, a simulated
    crash, a restore from ``root``, 5 more. -> (A's losses, B's losses,
    whether A's and B's params are bitwise identical)."""
    mgr = CheckpointManager(root, cfg.name,
                            CheckpointPolicy(incremental=True,
                                             async_write=False))
    print("run A: 10 uninterrupted steps")
    pa, _, la = run(cfg, acfg, init, 10, device)

    print("run B: 5 steps -> simulated crash -> restore -> 5 more")
    _, _, lb0 = run(cfg, acfg, init, 5, device, mgr=mgr, save_every=5)
    restored = mgr.restore(device=device)
    assert restored is not None
    p, o, s0 = restored
    print(f"  restored at step {s0}")
    pb, _, lb = run(cfg, acfg, init, 10, device, start=s0, state=(p, o))
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(tree_leaves(pa), tree_leaves(pb)))
    print(f"  bitwise identical to run A: {same}")
    return la, lb0 + lb, same


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg, acfg = config()

    def init():
        return init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)

    root = tempfile.mkdtemp(prefix="lc_elastic_torch_")
    try:
        _, _, same = crash_and_restore(cfg, acfg, init, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert same

    print("elastic: 256 devices -> lose 32 -> new mesh", end=" ")
    new_shape = shrink_mesh_shape(alive_devices=224, model=16)
    print(f"{new_shape} (data axis shrunk, model axis intact)")

    print("straggler mitigation: host 2 slow for 3 steps ->")
    sk = DeadlineSkipper(n_hosts=4, factor=2.0, cordon_after=3)
    for t in range(3):
        inc = sk.decide({0: 1.0, 1: 1.05, 2: 9.0, 3: 0.95})
    print(f"  include={inc}  cordoned={sk.stats.cordoned}")
    print("elastic_restart OK")


if __name__ == "__main__":
    main()
