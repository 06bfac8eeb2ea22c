"""Multi-tenant fleet serving on the PyTorch port — the flow of
``examples/serve_multitenant.py`` through ``repro_torch``: T fine-tuned
variants are separate IMAGES forked from one base
(``CheckpointManager(image=..., base_image=..., store=...)``), sharing base
layers in one store; each tenant costs O(its adapter) in storage, and
``replicate()`` to serving replicas that already hold the base ships ONLY
the adapter delta, which the ``FanoutStats`` printed below show. It runs
mixtral-8x7b's smoke config, as the JAX example does.

    PYTHONPATH=src python examples/serve_multitenant_torch.py           # card
    PYTHONPATH=src python examples/serve_multitenant_torch.py --device cpu
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
from repro_torch.ckpt.manager import unflatten_tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import LayerStore, push_delta  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

# the JAX example's three tenants: (edited leaf, edit)
DELTAS = [("final_norm", lambda p: p["final_norm"] * 2.0),
          ("embed", lambda p: p["embed"] + 0.5 * torch.sign(p["embed"])),
          ("final_norm", lambda p: p["final_norm"] * 0.5)]


def blob_bytes(root):
    total = 0
    for dp, _, fs in os.walk(os.path.join(root, "blobs")):
        for f in fs:
            total += os.path.getsize(os.path.join(dp, f))
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config("mixtral-8x7b")
    base = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       device)
    root = tempfile.mkdtemp(prefix="lc_tenants_torch_")
    policy = CheckpointPolicy(incremental=True, async_write=False, keep=100)
    opt = {"step": torch.tensor(0, dtype=torch.int32)}
    try:
        # ---- the trainer side: one base image, T tenant images, ONE store
        base_mgr = CheckpointManager(os.path.join(root, "train"), cfg.name,
                                     policy, image="base-model")
        base_mgr.save(0, base, opt)
        tag = base_mgr.tag_of(0)
        store = base_mgr.store
        b0 = blob_bytes(store.root)
        print(f"base image: {b0 / 1e6:.2f} MB")

        tenants = {}
        for i, (leaf, fn) in enumerate(DELTAS, start=1):
            variant = dict(base)
            variant[leaf] = fn(base)
            mgr = CheckpointManager("", cfg.name, policy, image=f"tenant{i}",
                                    base_image=("base-model", tag),
                                    store=store)  # the shared blob universe
            before = blob_bytes(store.root)
            rep = mgr.save(0, variant, opt)
            tenants[f"tenant{i}"] = (mgr, variant)
            print(f"tenant{i}: +{(blob_bytes(store.root) - before) / 1e3:.1f}"
                  f" KB on disk (delta on '{leaf}', "
                  f"{rep.layers_cached} base layers reused by id)")

        naive = b0 * (1 + len(DELTAS))
        print(f"store total: {blob_bytes(store.root) / 1e6:.2f} MB "
              f"(naive per-tenant copies: {naive / 1e6:.2f} MB)")

        # ---- the fleet side: replicas are seeded with the BASE image only;
        # replicating each tenant to them ships just the adapter delta,
        # because the have-set answers from the replica's whole committed
        # namespace (the base image vouches for every backbone blob).
        replicas = [LayerStore(os.path.join(root, f"replica{j}"))
                    for j in range(2)]
        for r in replicas:
            seeded = push_delta(store, r, "base-model", tag)
            print(f"seed {os.path.basename(r.root)} with base: "
                  f"{seeded.bytes_sent / 1e6:.2f} MB on the wire")

        for name, (mgr, _) in tenants.items():
            before = [blob_bytes(r.root) for r in replicas]
            fan = mgr.replicate(remote=replicas, step=0)
            assert fan.ok, [r.error for r in fan.replicas]
            wire = max(r.stats.bytes_sent for r in fan.replicas)
            disk = max(blob_bytes(r.root) - b
                       for r, b in zip(replicas, before))
            print(f"fan {name} -> {len(replicas)} base-holding replicas: "
                  f"rounds={fan.negotiation_rounds} "
                  f"source_reads={fan.source_blob_reads} "
                  f"wire<= {wire / 1e3:.1f} KB/replica "
                  f"disk<= {disk / 1e3:.1f} KB/replica "
                  f"(base would be {b0 / 1e6:.2f} MB)")

        # ---- the serving side: two tenants served FROM A REPLICA diverge
        # on the same prompts, each giving a direct engine's tokens on its
        # own edited weights
        prompts = np.random.default_rng(7).integers(
            0, cfg.vocab, (2, 12)).astype(np.int32)
        for name in list(tenants)[:2]:
            flat = replicas[0].load_image_payload(name, tag)
            tree = unflatten_tree({k[len("params/"):]: v
                                   for k, v in flat.items()
                                   if k.startswith("params/")})
            toks = Engine(cfg, tree, max_len=48, device=device).generate(
                prompts, steps=8).tokens
            direct = Engine(cfg, tenants[name][1], max_len=48,
                            device=device).generate(prompts, steps=8).tokens
            assert np.array_equal(toks, direct), name
            print(f"{name} serve:", toks[0].tolist())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("multitenant OK")


if __name__ == "__main__":
    main()
