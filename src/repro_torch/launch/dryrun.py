"""Multi-pod dry-run (torch port of ``repro/launch/dryrun.py``): trace every
(arch x shape x mesh) cell at production size without the hardware.

Each cell builds the step the trainer or server runs (``make_train_step``,
``make_prefill_step`` or ``make_decode_step`` with ``mesh=``) on the
production mesh, lays its inputs out as DTensors at the bundle's
``in_shardings`` from fake local tensors (``FakeTensorMode``: shapes and
dtypes, nothing allocated), runs it once under the roofline counter
(``roofline.analyze_step``) and writes the per-device FLOPs, bytes,
collectives and roofline terms in the reference's schema.

Deviation: the reference compiles for 512 host devices (its ``XLA_FLAGS``
line) and reads the partitioned program; the port traces rank 0 of a fake
world of 256 or 512 ranks (``init_process_group("fake")``), eagerly: for
evenly sharded programs every rank's totals are rank 0's. The meshed
train step ends by gathering its metrics, scalars, to every rank
(``full_tree``), a gather the reference's compiled step does not issue;
it is counted, as the port runs it.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both] [--jobs 4]
    python -m repro_torch.launch.dryrun ... --device cpu     # without a card

Like every entry point of the port, it traces on the card's device unless
``--device cpu`` is given (fake tensors allocate nothing there either).
``--all`` runs one subprocess per cell (the fake world is set up once a
process), ``--jobs`` of them at a time, and exits 1 if any cell fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import List, Optional, Tuple

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def model_flops_for(cfg, sp) -> float:
    """MODEL_FLOPS: 6·N·D train (3 matmul passes), 2·N·D forward-only.
    MoE: active params only."""
    n = cfg.active_param_count()
    if sp.kind == "train":
        return 6.0 * n * sp.global_batch * sp.seq_len
    if sp.kind == "prefill":
        return 2.0 * n * sp.global_batch * sp.seq_len
    return 2.0 * n * sp.global_batch          # decode: one token


def _fake_inputs(meta, shardings, device):
    """A tree of DTensors at ``shardings`` (NamedSharding leaves) with the
    shapes and dtypes of ``meta``'s leaves; call under ``FakeTensorMode``.
    Each rank keeps its block of the fake global tensor, as
    ``distribute_tensor`` cuts it, with no communication."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from ..sharding.ctx import placements
    if isinstance(meta, dict):
        return {k: _fake_inputs(meta[k], shardings[k], device) for k in meta}
    mesh = shardings.mesh
    full = torch.empty(meta.shape, dtype=meta.dtype, device=device)
    return distribute_tensor(full, mesh,
                             placements(mesh, shardings.spec, meta.ndim),
                             src_data_rank=None)


def _mesh_dims(mesh_name: str) -> Tuple[int, int]:
    """"DxM" -> (D, M): a ("data", "model") mesh other than the two
    production ones, for small traces."""
    parts = mesh_name.split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"mesh {mesh_name!r}: pod, multipod or DxM")
    return int(parts[0]), int(parts[1])


def run_cell(arch: str, shape: str, mesh_name: str,
             recipe_override: Optional[str] = None,
             extra: Optional[dict] = None,
             grad_reduce_dtype: Optional[str] = None,
             microbatches: int = 0, device=None) -> dict:
    """Trace one cell in a fake world that this call starts and ends (no
    group may be initialized before it) -> its result dict. ``mesh_name``
    is "pod" (16 x 16), "multipod" (2 x 16 x 16) or "DxM" (a small
    ("data", "model") mesh)."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..configs import SHAPES, get_config, input_specs
    from ..device import resolve_device
    from ..roofline import analyze_step
    from ..train import (TrainConfig, make_decode_step, make_prefill_step,
                         make_train_step)
    from .mesh import make_mesh, make_production_mesh

    device = resolve_device(device)
    cfg = get_config(arch)
    if extra:
        cfg = cfg.replace(**{k: v for k, v in extra.items()
                             if hasattr(cfg, k)})
    sp = SHAPES[shape]
    if mesh_name in ("pod", "multipod"):
        world = 512 if mesh_name == "multipod" else 256
    else:
        dims = _mesh_dims(mesh_name)
        world = dims[0] * dims[1]
    if dist.is_initialized():
        raise RuntimeError("run_cell starts its own fake world; a process "
                           "group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        if mesh_name in ("pod", "multipod"):
            mesh = make_production_mesh(multi_pod=mesh_name == "multipod",
                                        device=device)
        else:
            mesh = make_mesh(dims, ("data", "model"), device)
        specs = input_specs(cfg, shape)
        t0 = time.perf_counter()
        with FakeTensorMode():
            if sp.kind == "train":
                tcfg = TrainConfig(recipe=recipe_override,
                                   grad_reduce_dtype=grad_reduce_dtype,
                                   microbatches=microbatches)
                bundle = make_train_step(cfg, tcfg, sp.global_batch,
                                         sp.seq_len, mesh=mesh)
                pshape, oshape, _ = bundle.abstract_inputs
                batch = {k: specs[k] for k in bundle.in_shardings[2]}
                args = [_fake_inputs(m, s, device) for m, s in
                        zip((pshape, oshape, batch), bundle.in_shardings)]
            elif sp.kind == "prefill":
                bundle = make_prefill_step(cfg, sp.global_batch, sp.seq_len,
                                           mesh=mesh,
                                           recipe_name=recipe_override)
                metas = [bundle.abstract_inputs[0], specs["tokens"]]
                if cfg.n_prefix_embeds:
                    metas.append(specs["prefix_embeds"])
                args = [_fake_inputs(m, s, device)
                        for m, s in zip(metas, bundle.in_shardings)]
            else:  # decode: the last position of the cache
                bundle = make_decode_step(cfg, sp.global_batch, sp.seq_len,
                                          mesh=mesh,
                                          recipe_name=recipe_override)
                metas = (bundle.abstract_inputs[0], specs["cache"],
                         specs["tokens"])
                args = [_fake_inputs(m, s, device) for m, s in
                        zip(metas, bundle.in_shardings)] + [sp.seq_len - 1]
            res = analyze_step(
                bundle.fn, args, arch=arch, shape=shape, mesh_name=mesh_name,
                recipe=(recipe_override or bundle.recipe.name),
                model_flops=model_flops_for(cfg, sp),
                n_devices=mesh.size(), trace_seconds=time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    d = res.to_json()
    d["ok"] = True
    d["device"] = str(device)
    d["torch"] = torch.__version__
    return d


def cells(mesh_sel: str) -> List[Tuple[str, str, str]]:
    from ..configs import ARCH_IDS, applicable_shapes, get_config
    meshes = {"pod": ["pod"], "multipod": ["multipod"],
              "both": ["pod", "multipod"]}[mesh_sel]
    out = []
    for arch in ARCH_IDS:
        for shape in applicable_shapes(get_config(arch)):
            for m in meshes:
                out.append((arch, shape, m))
    return out


def result_path(arch: str, shape: str, mesh_name: str, tag: str = "") -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape}__{mesh_name}{suffix}.json")


def _cached_ok(path: str) -> bool:
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return bool(json.load(f).get("ok"))


def _cell_cmd(args, arch: str, shape: str, mesh_name: str) -> List[str]:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh_name]
    for flag, value in (("--recipe", args.recipe), ("--tag", args.tag),
                        ("--device", args.device),
                        ("--grad-reduce-dtype", args.grad_reduce_dtype)):
        if value:
            cmd += [flag, value]
    for kv in args.set:
        cmd += ["--set", kv]
    if args.microbatches:
        cmd += ["--microbatches", str(args.microbatches)]
    return cmd


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod",
                    help="pod, multipod, both, or DxM (a small mesh)")
    ap.add_argument("--recipe", default=None)
    ap.add_argument("--tag", default="", help="result filename suffix")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (ints only)")
    ap.add_argument("--grad-reduce-dtype", default=None)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells traced at once")
    args = ap.parse_args(argv)
    if args.mesh not in ("pod", "multipod", "both"):
        _mesh_dims(args.mesh)
        if args.all:
            ap.error("--all takes --mesh pod, multipod or both")

    extra = {}
    for kv in args.set:
        k, v = kv.split("=")
        extra[k] = int(v) if v.lstrip("-").isdigit() else v

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required without --all")
        meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
        failed = 0
        for m in meshes:
            path = result_path(args.arch, args.shape, m, args.tag)
            try:
                d = run_cell(args.arch, args.shape, m, args.recipe, extra,
                             grad_reduce_dtype=args.grad_reduce_dtype,
                             microbatches=args.microbatches,
                             device=args.device)
            except Exception as e:    # the cell's record holds the failure
                d = {"arch": args.arch, "shape": args.shape, "mesh": m,
                     "ok": False, "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-2000:]}
            with open(path, "w") as f:
                json.dump(d, f, indent=1, default=str)
            failed += not d.get("ok")
            status = "OK" if d.get("ok") else f"FAIL ({d.get('error')})"
            print(f"[dryrun] {args.arch} x {args.shape} x {m}: {status}",
                  flush=True)
        return 1 if failed else 0

    # --all: one subprocess per cell (a fake world a process), --jobs at
    # once; one-token steps first, then prefill, then train (the longest
    # traces: a microbatch loop of forward, remat and backward in Python)
    from ..configs import SHAPES
    order = {"decode": 0, "prefill": 1, "train": 2}
    todo = []
    for arch, shape, m in sorted(cells(args.mesh),
                                 key=lambda c: order[SHAPES[c[1]].kind]):
        if not args.force and _cached_ok(result_path(arch, shape, m,
                                                     args.tag)):
            print(f"[dryrun] {arch} x {shape} x {m}: cached", flush=True)
        else:
            todo.append((arch, shape, m))
    failures, running = [], []
    t0 = time.perf_counter()

    def reap(cell, proc, log) -> None:
        log.seek(0)
        out = log.read().decode(errors="replace")
        log.close()
        lines = [ln for ln in out.splitlines() if ln.startswith("[dryrun]")]
        print(lines[-1] if lines else out[-3000:], flush=True)
        if proc.returncode != 0:
            failures.append(cell)

    try:
        for cell in todo:
            while len(running) >= max(1, args.jobs):
                done = [r for r in running if r[1].poll() is not None]
                for r in done:
                    running.remove(r)
                    reap(*r)
                if not done:
                    time.sleep(0.2)
            log = tempfile.TemporaryFile()
            running.append((cell, subprocess.Popen(
                _cell_cmd(args, *cell), stdout=log,
                stderr=subprocess.STDOUT), log))
        while running:
            cell, proc, log = running.pop(0)
            proc.wait()
            reap(cell, proc, log)
    finally:        # interrupted: no cell outlives the run
        for _, proc, log in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    print(f"[dryrun] done: {len(todo) - len(failures)}/{len(todo)} OK in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for f3 in failures:
        print("  FAILED:", f3, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
