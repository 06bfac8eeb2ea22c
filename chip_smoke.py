#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) once on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of the repository

It builds the port's three CUDA libraries from the sources in the
checkout (one nvcc each, all at once), logs each library's registers and
spills as ptxas reports them (and fails if ptxas serialised a kernel's
wgmma, or if one of the SSD scan's or the f32 flash kernels spills), and
holds each kernel against its plain torch version on edge cases: the
fingerprint bit-exactly, flash attention (its f32 kernel, three TF32
products a product on ``mma.sync``, and its bf16 ``wgmma`` kernel) and
the SSD scan (f32 also as three TF32 products a product) within the JAX
kernel tests' tolerances. It checks the f32
smoke model of every arch of the registry on the card against the CPU,
and the MoE dispatch (``moe_dispatch``) at full mixtral-8x7b and
granite-moe-3b-a800m width, then runs the serving half of the main path

    save (full, fingerprinted) -> CheckpointFollower.poll -> engine + serve
    -> incremental save -> follower.poll_and_refresh(engine) -> serve

at the full width of yi-6b (dense, its depth cut to ``YI_SERVE_LAYERS``,
3.8 GB of bf16 weights), mixtral-8x7b (moe, its depth cut to
``MIXTRAL_LAYERS``, 12.1 GB), minicpm3-4b (mla, all 62 layers, 8.5 GB)
and hymba-1.5b (hybrid, 2.8 GB, 4096-token prompts), weights drawn on the
card from a seeded generator. The smart followers
(yi-6b, mixtral-8x7b, minicpm3-4b) pull from the trainer's store
into a replica store (the second pull must carry exactly the chunks the
incremental save wrote); on yi-6b a blob then rotted at rest in the
replica must be caught by the follower's verify gate and healed by
``repair_image``. hymba's follower has no live peer: it applies the
bundles the manager publishes into a registry directory, with no
negotiation. On every layer of hymba's prefill it then calls
the flash attention and SSD scan entry points on the tensors the model
computes and holds them against the model's own results (the served
models, as in the JAX package, run the plain attention and scan), and
times each kernel beside its bound, its plain version and, for attention,
``scaled_dot_product_attention``; last at yi-6b's attention shape (bf16
and f32), hymba-1.5b's in f32, mamba2-130m's scan shape (bf16 and f32)
and hymba-1.5b's in f32. The SSD scan runs as three CUDA
kernels a call (chunk state, state passing, chunk scan); its launches
count calls, and each of the three CUDA kernels is counted as well.

The store's remaining surface rides the same serving paths. On
yi-6b's tree, ``fp_per_leaf`` runs the per-leaf fingerprint baseline
(``fingerprint_tree``: one launch per leaf) against the packed table.
After mixtral-8x7b's refresh, ``tenants`` forks three tenant images from
the trainer's step 0 into its store (``CheckpointManager(store=,
base_image=)``, the deltas of ``examples/serve_multitenant.py``), with the
base's layer ids reused as the DLC rules say, and one tenant saved
incrementally through the per-leaf path; ``replicate`` fans each tenant to
the follower's replica and to a second replica seeded with the base, which
must receive only the chunks they lack, and serves two tenants restored
from the second replica. After hymba's passive refresh, ``scrub`` scrubs
the follower's replica whole and in 256 MiB slices, finds exactly one
blob rotted at rest with its attribution, heals it with ``repair_image``
from the trainer's store and serves the healed head.

On yi-6b's path, too: ``fp_tree`` runs the entry point
``kernels.fingerprint.ops.fingerprint_tree`` (one launch, bit-equal to
the packed and plain tables), ``specs`` holds ``param_specs`` against the
served tree, ``steps`` decodes greedily through ``make_prefill_step`` and
``make_decode_step`` (the tokens of ``Engine.generate``), and ``sample``
checks sampled decoding (seeds reproduce; T 1e-4 is greedy where the top
two logits are apart). Before the serving paths, ``watchdog`` trains with
``launch.train --watchdog-s 60`` and ``examples`` runs
``examples/elastic_restart_torch.py`` and
``examples/finetune_lora_ckpt_torch.py`` on the card, their own asserts
holding.

Last, the training half of the main path (phase ``train``): full-width
yi-6b with its depth cut to ``TRAIN_LAYERS`` trains through
``make_train_step``, is saved in full with its optimizer state, trains on,
is saved incrementally through the fingerprint kernel, restored, refreshed
into an engine and served; the kernel is then held bit for bit against its
plain version on that training tree and timed, and ``remat_outputs`` holds
one ``value_and_grad`` under remat "outputs" against "none" (and
"nothing"), with each one's peak memory. ``reference_check`` also runs
one f32 train step on the card against the CPU. Then ``mesh_1x1``: the
same model trained through the sharded step on a 1x1 NCCL ``DeviceMesh``
(recipe ``tp``, ZeRO-1), bit-equal to the one-device step, saved
through the manager (the gathered state; the fingerprint kernel's
launches are read for the main path), ``reshard_restore``-d onto the
mesh bit for bit, its prefill step's logits (a DTensor at the step's
``out_shardings``, gathered there) equal to one device's,
``compressed_psum`` on the 64000 x 4096 embedding gradient equal to the
same call on the CPU, and the train launcher with ``--mesh 1x1``; and
``mesh_archs``: every arch's f32 smoke model under each recipe through
the meshed train, prefill and decode steps, bit-equal to one device.

The roofline and the dry-run: ``roofline`` (after ``train``) counts one
train step of the train phase's model, and the 8-layer serving model's
prefill and decode steps, with ``repro_torch.roofline`` on the card's
tensors and again traced on fake tensors in the same process; the FLOP
counts must be equal, and each is printed beside its roofline terms
(one H100) and the step's measured time (``train_flops``'s hand count
beside the train step's). ``dryrun``: five cells of
``python -m repro_torch.launch.dryrun`` at production size on fake
worlds of 256 and 512 ranks (``DRYRUN_CELLS``), traced on the host by a
thread started with the script, one subprocess after another while the
card runs the other phases; each must end with ``ok: true``, and three
must stay inside ``DRYRUN_LIMITS``: yi-6b's meshed decode under 100 MB
of collective bytes a step, mixtral-8x7b's prefill on two pods at ten
times its old useful FLOP share or more, gemma-2b's prefill under "sp"
below its old memory term.

``split_attention`` (after ``mesh_archs``) runs what each rank of those
meshed paths computes, at production width on the card: the split-cache
decode of one yi-6b layer's full cache over 16 length blocks, merged by
flash-decoding's combine, and the query-offset attention over 16 query
blocks, each against the unsplit function, bf16 and f32.

``dlc_baseline`` (after ``split_attention``, ~16 s) builds ``FROM yi-6b;
COPY params; CMD serve`` from yi-6b's full-width weights cut to
``DLC_LAYERS`` in two stores, ``LayerStore(record_fingerprints=False)``
(the seed's Docker-faithful COPY cache check) and the default, rebuilds
it unchanged and injects one edited leaf: the flag-off rebuild must hash
the whole layer with no fingerprint launch, the default one hash nothing
with one launch, both stores' checksums must be equal, and the two
incremental saves must write the same chunks.

``crash_save`` (after ``dlc_baseline``, ~30 s) kills a trainer mid-save
and restarts it: a child process (``crash_save_child``) draws the same
weights on the card, saves step 1 in full and dies by SIGKILL inside
``LayerStore.write_blob`` of the incremental save of step 2, after its
first new blob. Only step 1 may then be visible, deep-verified and
restored onto the card bit for bit (by fingerprint table); a fresh
manager saves step 2 again from an empty fingerprint baseline, so it
hashes the whole tree on the host, and must inject, write only the
changed chunks the child did not land, and restore bit for bit.

Each phase prints one line of its own numbers and raises on a failed check.
The last three lines are the kernels' summary (JSON), the card's name and
power limit as nvidia-smi gives them, and {"ok": true, "device": ...}.
Without a CUDA device it exits non-zero before printing any result. The
temporary stores live under the system temp directory and are removed at
exit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the float32 rate
# outside the tensor cores, the only 32-bit CUDA-core rate the sheet gives
# (the fingerprint's work is 32-bit integer ALU operations).
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12     # dense bf16 on the tensor cores
TF32_TENSOR_OPS_PER_S = 495e12     # dense TF32 on the tensor cores
# the f32 kernels (flash attention's, the SSD scan's) take each product as
# three TF32 products (3xTF32: hi.hi + hi.lo + lo.hi), their bound as such
# beside the CUDA cores'
F32_TF32_PRODUCTS = 3
# integer operations per u32 lane of the fingerprint: 3 multiplies, 1 add,
# 2 xors and 1 shift in the mix, 1 xor and 1 add into the row's sums
FP_OPS_PER_LANE = 9
# the train phase: yi-6b at full width, depth cut so that 16 bytes a
# parameter (bf16 param and grad, f32 master, m, v) fit on one card
TRAIN_LAYERS = 4
TRAIN_STEPS = 2          # steps before each of the two saves
# mixtral-8x7b at full width, depth cut: its 32 layers are 93.4 GB of bf16
# params; 4 layers are 12.13 GB, the size of yi-6b's full tree
MIXTRAL_LAYERS = 4
# yi-6b's serving path at full width, depth cut to keep the whole script
# well inside its time limit; mixtral's path carries a 12.1 GB tree
YI_SERVE_LAYERS = 8
CARD_SHELL = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, sort_keys=True, default=str),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn`` (launches on the current stream, no host
    synchronisation) from a CUDA graph of one call, replayed ``reps``
    times: what the card spends, without the host's time between launches.
    ``fn`` runs once before the capture (builds, allocations)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms


def phase_build():
    """Build every kernel of the port at once (one nvcc per source)."""
    from repro_torch.kernels.build import build_all, ptxas_report
    from repro_torch.kernels.fingerprint import ops as fp_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    mods = {"fingerprint": fp_ops, "flash_attention": fa_ops,
            "ssd_scan": ssd_ops}
    t0 = time.perf_counter()
    paths = build_all({name: m.SOURCE for name, m in mods.items()})
    for m in mods.values():
        m.load_library()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        with open(path + ".ptxas.txt") as f:
            ptxas[name] = ptxas_report(f.read())
    for name in ("flash_attention", "ssd_scan"):
        check(not ptxas[name]["wgmma_serialized"],
              f"ptxas serialised the {name} kernel's wgmma: "
              f"{ptxas[name]['wgmma_serialized']}")
    scan = ptxas["ssd_scan"]["kernels"]
    check(len(scan) == 5 and all(
        k.get("spill_stores", 1) == 0 and k.get("spill_loads", 1) == 0
        for k in scan), f"the SSD kernels spill (or are missing): {scan}")
    fa_f32 = [k for k in ptxas["flash_attention"]["kernels"]
              if "fa_kernel" in k["name"]]
    check(len(fa_f32) == 3 and all(
        k.get("spill_stores", 1) == 0 and k.get("spill_loads", 1) == 0
        for k in fa_f32), f"the f32 flash kernels spill (or are missing): "
        f"{fa_f32}")
    plans = {d: fa_ops.tile_plan(d)["smem_bytes"] for d in fa_ops.HEAD_DIMS}
    f32_plans = {d: fa_ops.f32_tile_plan(d)["smem_bytes"]
                 for d in fa_ops.HEAD_DIMS}
    lib = fa_ops.load_library()
    check(all(lib.fa_bf16_smem_bytes(d) == b for d, b in plans.items()),
          "ops.tile_plan disagrees with the kernel's shared memory")
    check(all(lib.fa_f32_smem_bytes(d) == b for d, b in f32_plans.items()),
          "ops.f32_tile_plan disagrees with the kernel's shared memory")
    ssd_lib = ssd_ops.load_library()
    ssd_plans = {}
    for dtype in (torch.float32, torch.bfloat16):
        for q, n, p in ((128, 16, 64), (128, 128, 64), (64, 128, 64),
                        (7, 8, 24), (128, 32, 72)):
            for ph, groups in ((1, 1), (3, 1), (3, 2), (3, 4)):
                if dtype == torch.float32 and groups > 1:
                    continue
                want = ssd_ops.smem_bytes(ph, dtype, q, n, p, groups)
                check(ssd_lib.ssd_smem_bytes(ph, int(dtype == torch.bfloat16),
                                             q, n, p, groups) == want,
                      f"ops.smem_bytes disagrees with the SSD kernel's: "
                      f"phase {ph}, {dtype}, Q {q}, N {n}, P {p}, "
                      f"{groups} groups")
                ssd_plans[f"{str(dtype)[6:]} ph{ph} Q{q} N{n} P{p} "
                          f"g{groups}"] = want
    log("build", seconds=secs, card=torch.cuda.get_device_name(0),
        cuda=torch.version.cuda, torch=torch.__version__,
        built=sorted(paths), ptxas=ptxas, flash_bf16_smem_bytes=plans,
        flash_f32_smem_bytes=f32_plans,
        ssd_smem_bytes=ssd_plans)


def _device_tree(dev):
    """Leaves that reach every path of the kernel: each dtype width, bool,
    64-bit values with the high bit set, ragged last chunks, rows wider
    than one 32 KiB block, an empty and a 0-d leaf, and a leaf whose data
    starts off a 16-byte boundary."""
    rng = np.random.default_rng(11)
    g = torch.Generator(device=dev).manual_seed(11)
    base = torch.randn(70001, generator=g, device=dev)
    return {
        "f32_ragged": torch.randn(5000, generator=g, device=dev),
        "bf16_wide": torch.randn(3 * (1 << 19) + 5, generator=g,
                                 device=dev).to(torch.bfloat16),
        "bool": torch.randn(1000, generator=g, device=dev) > 0,
        "i64": torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, 300001,
                                             dtype=np.int64)).to(dev),
        "u8": torch.randint(0, 256, (3333,), generator=g, device=dev,
                            dtype=torch.uint8),
        "f64": torch.randn(129, generator=g, device=dev, dtype=torch.float64),
        "empty": torch.zeros(0, device=dev),
        "scalar": torch.tensor(3.5, device=dev),
        "f32_offset": base[1:],
    }


def phase_kernel_edges(dev) -> int:
    from repro_torch.core.fingerprint import chunk_geometry
    from repro_torch.core.chunker import dtype_str, shape_of
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.kernels.fingerprint.ref import fingerprint_rows_plain
    tree = _device_tree(dev)
    rows = 0
    for cb in (1 << 20, 1024, 1000, 64):
        leaves = [t.contiguous() for t in tree.values()]
        geom = [chunk_geometry(shape_of(t), dtype_str(t), cb) for t in leaves]
        got = fingerprint_leaves(leaves, geom)
        want = fingerprint_rows_plain(leaves, geom)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"fingerprint kernel != plain on the edge tree, chunk {cb}")
        rows += got.shape[0]
    log("kernel_edges", leaves=sorted(tree), chunk_sizes=[1 << 20, 1024,
        1000, 64], rows=rows, bit_exact=True)
    return rows


def phase_fingerprint_full(payload_union, chunk_bytes,
                           phase: str = "fingerprint_full") -> dict:
    """The kernel at the main path's shapes: the whole full-width tree."""
    from repro_torch.core.chunker import dtype_str, shape_of
    from repro_torch.core.fingerprint import chunk_geometry
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.kernels.fingerprint.ref import fingerprint_rows_plain
    dev = next(t.device for t in payload_union.values() if t.is_cuda)
    leaves = [t.to(dev).contiguous() for t in payload_union.values()]
    geom = [chunk_geometry(shape_of(t), dtype_str(t), chunk_bytes)
            for t in leaves]
    got = fingerprint_leaves(leaves, geom)
    want = fingerprint_rows_plain(leaves, geom)
    max_abs_err = int((got.long() - want.long()).abs().max())
    check(max_abs_err == 0, "fingerprint kernel != plain on the full tree")
    ms = cuda_ms(lambda: fingerprint_leaves(leaves, geom), 10)
    plain_ms = cuda_ms(lambda: fingerprint_rows_plain(leaves, geom), 2)
    rows = int(got.shape[0])
    lanes = sum(n * w for n, w in geom)
    in_bytes = sum(t.numel() * t.element_size() for t in leaves)
    out_bytes = rows * 8
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = lanes * FP_OPS_PER_LANE / ALU32_OPS_PER_S * 1e3
    res = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs_err,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
           "tree_bytes": in_bytes, "rows": rows, "lanes": lanes}
    log(phase, **res)
    return res


def phase_fp_per_leaf(union, chunk_bytes) -> dict:
    """The per-leaf fingerprint baseline (``packed_fingerprints=False``) on
    the main path's tree: one kernel launch and one D2H copy per leaf,
    bit-equal to the packed table and to the plain version."""
    from repro_torch.core import (fingerprint_tree, fingerprint_tree_packed,
                                  tree_pack_index)
    from repro_torch.core.chunker import dtype_str, shape_of
    from repro_torch.core.fingerprint import chunk_geometry
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.kernels.fingerprint.ref import fingerprint_rows_plain
    dev = next((t.device for t in union.values() if t.is_cuda),
               torch.device("cpu"))
    fingerprint_leaves.launches = 0
    per_leaf = fingerprint_tree(union, chunk_bytes)
    launches = fingerprint_leaves.launches
    packed = fingerprint_tree_packed(union, chunk_bytes)
    leaves = [t.to(dev).contiguous() for t in union.values()]
    plain = fingerprint_rows_plain(
        leaves, [chunk_geometry(shape_of(t), dtype_str(t), chunk_bytes)
                 for t in leaves]).cpu().numpy()
    index, _, _ = tree_pack_index(union, chunk_bytes)
    check(launches == len(union),
          f"per-leaf fingerprints made {launches} launches for "
          f"{len(union)} leaves")
    check(all(np.array_equal(per_leaf[n], packed[n])
              and np.array_equal(per_leaf[n], plain[off:off + k])
              for n, off, k in index),
          "per-leaf fingerprints != packed / plain")
    res = {"leaves": len(union), "launches": launches, "bit_exact": True,
           "per_leaf_ms": _host_ms(
               lambda: fingerprint_tree(union, chunk_bytes), 3, dev),
           "packed_ms": _host_ms(
               lambda: fingerprint_tree_packed(union, chunk_bytes), 3, dev)}
    log("fp_per_leaf", **res)
    return res


def phase_fp_tree(union, chunk_bytes) -> dict:
    """``kernels.fingerprint.ops.fingerprint_tree`` (the counterpart of the
    reference's entry point) on the main path's tree: one launch and one
    D2H copy, its table bit-equal to the packed ``fingerprint_leaves``
    table and to the plain version. Both timed by CUDA events: the entry
    point with its D2H copy and host split, the packed launch alone."""
    from repro_torch.core import tree_pack_index
    from repro_torch.core.chunker import dtype_str, shape_of
    from repro_torch.core.fingerprint import chunk_geometry
    from repro_torch.kernels.fingerprint.ops import (fingerprint_leaves,
                                                     fingerprint_tree)
    from repro_torch.kernels.fingerprint.ref import fingerprint_rows_plain
    dev = next(t.device for t in union.values() if t.is_cuda)
    leaves = [t.to(dev).contiguous() for t in union.values()]
    geom = [chunk_geometry(shape_of(t), dtype_str(t), chunk_bytes)
            for t in leaves]
    fingerprint_leaves.launches = 0
    got = fingerprint_tree(union, chunk_bytes)
    launches = fingerprint_leaves.launches
    packed = fingerprint_leaves(leaves, geom).cpu().numpy()
    plain = fingerprint_rows_plain(leaves, geom).cpu().numpy()
    index, rows, _ = tree_pack_index(union, chunk_bytes)
    check(launches == 1, f"fingerprint_tree made {launches} launches")
    check(list(got) == list(union) and all(
        np.array_equal(got[n], packed[off:off + k])
        and np.array_equal(got[n], plain[off:off + k])
        for n, off, k in index), "fingerprint_tree != packed / plain")
    res = {"leaves": len(union), "rows": rows, "launches": launches,
           "bit_exact": True,
           "tree_ms": cuda_ms(lambda: fingerprint_tree(union, chunk_bytes), 5),
           "packed_ms": cuda_ms(lambda: fingerprint_leaves(leaves, geom), 5)}
    log("fp_tree", **res)
    return res


def phase_specs(cfg, params) -> dict:
    """``param_specs`` (meta tensors) against the served tree: the same
    paths, shapes and dtypes, so the same bytes."""
    from repro_torch.models import param_specs
    specs, served = _flat(param_specs(cfg)), _flat(params)
    check(sorted(specs) == sorted(served) and all(
        tuple(specs[k].shape) == tuple(served[k].shape)
        and specs[k].dtype == served[k].dtype and specs[k].is_meta
        for k in served), "param_specs differ from the served tree")
    res = {"model": cfg.name, "layers": cfg.n_layers, "leaves": len(specs),
           "spec_bytes": _nbytes(specs), "served_bytes": _nbytes(params)}
    check(res["spec_bytes"] == res["served_bytes"], f"specs bytes {res}")
    log("specs", **res)
    return res


def phase_steps(cfg, eng, prompts, new_tokens: int) -> dict:
    """``make_prefill_step`` and ``make_decode_step`` on the engine's params:
    the prefill cache spliced into a decode cache as the engine splices
    it, then greedy decode steps; the tokens must equal
    ``Engine.generate``'s. Records each step's gap between the top two
    logits (``phase_sample`` reads it) and times both steps."""
    from repro_torch.models import init_cache
    from repro_torch.train import make_decode_step, make_prefill_step
    dev = eng.device
    B, S = prompts.shape
    greedy = eng.generate(prompts, new_tokens).tokens
    prefill = make_prefill_step(cfg, B, S, dev).fn
    decode = make_decode_step(cfg, B, eng.max_len, dev).fn
    toks = torch.as_tensor(prompts, device=dev)
    t0 = time.perf_counter()
    pf_cache, logits = prefill(eng.params, toks)
    cache = eng._splice(init_cache(cfg, B, eng.max_len, dev), pf_cache, S)
    out = np.zeros((B, new_tokens), np.int32)
    gaps = np.zeros((B, new_tokens))
    for i in range(new_tokens):
        lg = logits[:, :cfg.vocab].float()
        top = torch.topk(lg, 2).values
        gaps[:, i] = (top[:, 0] - top[:, 1]).cpu().numpy()
        tok = torch.argmax(lg, dim=-1)
        out[:, i] = tok.cpu().numpy()
        cache, logits = decode(eng.params, cache, tok, S + i)
    steps_s = time.perf_counter() - t0
    check(np.array_equal(out, greedy),
          "the step bundles' greedy tokens differ from Engine.generate's")
    res = {"model": cfg.name, "batch": B, "prompt_len": S,
           "new_tokens": new_tokens, "tokens_equal": True,
           "seconds": steps_s,
           "prefill_ms": _host_ms(lambda: prefill(eng.params, toks), 3, dev),
           "decode_step_ms": _host_ms(lambda: decode(
               eng.params, cache, tok, S + new_tokens - 1), 5, dev),
           "min_top2_gap": float(gaps.min())}
    log("steps", **res)
    res.update(greedy=greedy, gaps=gaps)
    return res


SAMPLE_T = 0.7
NEAR_ZERO_T = 1e-4


def phase_sample(cfg, eng, prompts, new_tokens: int, greedy, gaps) -> dict:
    """Sampled decoding on the served engine: one seed gives the same
    tokens twice and another seed other tokens (T 0.7); at T 1e-4 each
    row gives the greedy tokens up to its first step whose top two logits
    lie within 30 T (the difference of two Gumbel draws passes 30 with
    probability below 1e-13; a bf16 logit tie is a coin toss, as it is for
    the reference); tokens/s sampled against greedy, host-timed."""
    B = prompts.shape[0]
    a = eng.generate(prompts, new_tokens, SAMPLE_T, 1).tokens
    b = eng.generate(prompts, new_tokens, SAMPLE_T, 1).tokens
    c = eng.generate(prompts, new_tokens, SAMPLE_T, 2).tokens
    check(np.array_equal(a, b), "one seed gave two token sequences")
    check(not np.array_equal(a, c), "two seeds gave the same tokens")
    check(bool(((a >= 0) & (a < cfg.vocab)).all()), "token out of range")
    cold = eng.generate(prompts, new_tokens, NEAR_ZERO_T, 0).tokens
    apart = gaps > 30 * NEAR_ZERO_T
    upto = np.where(apart.all(1), new_tokens, np.argmin(apart, axis=1))
    check(all(np.array_equal(cold[r, :upto[r]], greedy[r, :upto[r]])
              for r in range(B)), "T 1e-4 left the greedy tokens")
    check(int(upto.sum()) > 0, "no step's top two logits were apart")

    def tokens_per_s(temperature):
        t = time.perf_counter()
        eng.generate(prompts, new_tokens, temperature, 3)
        return B * new_tokens / (time.perf_counter() - t)

    res = {"model": cfg.name, "temperature": SAMPLE_T,
           "seeds_reproduce": True, "tokens_moved_by_seed": int((a != c).sum()),
           "tokens_moved_from_greedy": int((a != greedy).sum()),
           "near_zero_t_tokens_equal_greedy": int(upto.sum()),
           "rows_with_a_near_tie": int((upto < new_tokens).sum()),
           "greedy_tokens_per_s": tokens_per_s(0.0),
           "sampled_tokens_per_s": tokens_per_s(SAMPLE_T)}
    log("sample", **res)
    return res


def phase_watchdog() -> dict:
    """``launch.train.main --watchdog-s 60`` on yi-6b's smoke config on the
    card: the watchdog is armed around each of 4 steps and never fires."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "yi-6b", "--smoke", "--steps", "4", "--batch",
                    "2", "--seq", "64", "--watchdog-s", "60", "--device",
                    "cuda"])
    text = buf.getvalue()
    check("[watchdog]" not in text, "the watchdog fired on a healthy step")
    check("[train] 4 steps in" in text, f"the launcher did not train:\n{text}")
    res = {"seconds": time.perf_counter() - t0, "fired": False,
           "last_line": text.strip().splitlines()[-1]}
    log("watchdog", **res)
    return res


def phase_examples() -> dict:
    """``examples/elastic_restart_torch.py`` and
    ``examples/finetune_lora_ckpt_torch.py`` with ``--device cuda``, called
    in process: their own asserts (a crashed and restored run bitwise equal
    to an uninterrupted one; incremental saves under a tenth of full
    ones' bytes) must hold on the card."""
    import contextlib
    import importlib.util
    import io
    res = {}
    for name, ok in (("elastic_restart_torch", "elastic_restart OK"),
                     ("finetune_lora_ckpt_torch", "finetune_lora_ckpt OK")):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(["--device", "cuda"])
        text = buf.getvalue()
        check(ok in text, f"{name} did not finish:\n{text}")
        res[name] = {"seconds": time.perf_counter() - t0,
                     "output": text.strip().splitlines()[-6:]}
    log("examples", **res)
    return res


# -------------------------------------------------- flash attention, SSD scan
# B, Hq, KVH, S, D, window, causal, scale
FA_EDGE_CASES = [
    (2, 4, 2, 128, 64, None, True, None),     # tests/test_kernels.py FA_CASES
    (1, 4, 4, 256, 32, None, True, None),
    (2, 8, 2, 128, 64, 32, True, None),
    (1, 2, 1, 64, 128, None, True, None),
    (1, 4, 2, 200, 64, None, True, None),     # ragged S: a partial last tile
    (2, 4, 2, 200, 128, 50, True, None),      # ragged S inside a band
    (1, 4, 1, 128, 32, None, False, None),    # not causal
    (1, 4, 2, 160, 64, 48, False, 0.3),       # a window alone, explicit scale
    (1, 2, 1, 256, 64, 40, True, None),       # first KV tile wholly masked
                                              # for the late rows of a tile
    # ragged S and many KV tiles of 128 keys: the last query tile's block
    # visits 10, 9 and 11 of them, wrapping the bf16 kernel's ring of 4
    # (D 32, 64) or 3 (D 128) stages at least twice
    (1, 4, 2, 1300, 64, 1100, True, None),    # a window and GQA
    (2, 5, 1, 1100, 128, None, True, None),
    (1, 4, 2, 1300, 32, None, False, 0.3),    # not causal, explicit scale
    (1, 4, 2, 1000, 64, 300, True, None),     # a narrow band: 3-4 tiles
]
# B, S, H, P, G, N, chunk, |A| scale
SSD_EDGE_CASES = [
    (2, 64, 3, 8, 1, 16, 16, 1.0),            # tests/test_kernels.py SSD_CASES
    (1, 128, 4, 16, 2, 8, 32, 1.0),
    (2, 64, 4, 8, 4, 16, 64, 1.0),
    (1, 192, 2, 64, 1, 128, 192, 0.1),        # N 128; kernel chunks 128 + 64
    (1, 256, 4, 24, 2, 16, 128, 1.0),         # P 24: a partial P tile
    (2, 256, 3, 64, 1, 16, 128, 40.0),        # exp above the diagonal is inf
    (2, 4096, 4, 64, 2, 32, 128, 1.0),        # 32 chunks passed state, G 2
    (1, 200, 3, 20, 1, 10, 128, 1.0),         # P, N not multiples of 8 (nor
                                              # N of 4): bf16 plain loads and
                                              # stores, a short last chunk
]
# f32 only: |A| small, so the decay stays near 1 and the states and y sum
# every term at full weight over long runs, where a truncating adder in the
# tensor cores' sums would show
SSD_F32_CASES = [
    (1, 1024, 2, 64, 1, 128, 128, 0.01),
]
# cases run again with x, Bc and Cc each a contiguous view one element into
# its storage: no longer 16-byte aligned, so the bf16 kernels take their
# plain loads and stores at shapes that would allow 16-byte ones
SSD_UNALIGNED_CASES = [
    (2, 256, 4, 64, 2, 16, 128, 1.0),
]
# f32 cases run again with q, k and v each a contiguous view one element
# into its storage: the f32 kernel then copies K and V in 4-byte pieces
FA_UNALIGNED_CASES = [
    (2, 4, 2, 200, 128, 50, True, None),
    (1, 4, 2, 1300, 64, 1100, True, None),
]
FA_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
SSD_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _flash_inputs(g, B, Hq, KVH, S, D, dtype, dev):
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((B, Hq, S, D), (B, KVH, S, D), (B, KVH, S, D)))


def _ssd_inputs_seeded(g, B, S, H, P, G, N, a_scale, dtype, dev):
    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = rn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(rn(H) * 0.5) * a_scale
    Bc = (rn(B, S, G, N) * 0.3).to(dtype)
    Cc = (rn(B, S, G, N) * 0.3).to(dtype)
    D = rn(H) * 0.1
    return x, dt, A, Bc, Cc, D


def phase_flash_edges(dev) -> None:
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reference)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(21)
    worst, worst_case = {}, {}
    runs = [(c, dt, False) for c in FA_EDGE_CASES
            for dt in (torch.float32, torch.bfloat16)] + \
        [(c, torch.float32, True) for c in FA_UNALIGNED_CASES]
    for case, dtype, unaligned in runs:
        B, Hq, KVH, S, D, win, causal, scale = case
        q, k, v = _flash_inputs(g, B, Hq, KVH, S, D, dtype, dev)
        if unaligned:
            q, k, v = (_one_element_in(t) for t in (q, k, v))
            check(all(t.data_ptr() % 16 for t in (q, k, v)),
                  "unaligned views")
        kw = dict(causal=causal, window=win, scale=scale)
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = _max_err(got, reference(q, k, v, **kw))
        check(err < FA_TOL[dtype],
              f"flash {case} {dtype} unaligned={unaligned}: {err}")
        name = str(dtype).split(".")[-1] + ("_unaligned" if unaligned
                                            else "")
        if err >= worst.get(name, 0.0):
            worst[name], worst_case[name] = err, case
    log("kernel_edges_flash", cases=len(FA_EDGE_CASES), dtypes=2,
        unaligned_f32_cases=len(FA_UNALIGNED_CASES),
        max_abs_err=worst, worst_case=worst_case,
        tol={"float32": 3e-5, "bfloat16": 3e-2},
        seconds=time.perf_counter() - t0)


def _one_element_in(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element into its
    storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_ssd_edges(dev) -> None:
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.models.ssm import ssd_chunked, ssd_reference
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(22)
    worst, long_sums, long_secs = {}, None, 0.0
    both = (torch.float32, torch.bfloat16)
    cases = [(c, False, both) for c in SSD_EDGE_CASES] + \
        [(c, True, both) for c in SSD_UNALIGNED_CASES] + \
        [(c, False, (torch.float32,)) for c in SSD_F32_CASES]
    for case, unaligned, dtypes in cases:
        B, S, H, P, G, N, chunk, a_scale = case
        t_case = time.perf_counter()
        for dtype in dtypes:
            args = _ssd_inputs_seeded(g, B, S, H, P, G, N, a_scale, dtype,
                                      dev)
            if unaligned:
                x, dt, A, Bc, Cc, D = args
                x, Bc, Cc = (_one_element_in(t) for t in (x, Bc, Cc))
                check(all(t.is_contiguous() and t.data_ptr() % 16
                          for t in (x, Bc, Cc)), "unaligned views")
                args = x, dt, A, Bc, Cc, D
            y, h = ssd(*args, chunk=chunk)
            torch.cuda.synchronize()
            y_p, h_p = ssd_chunked(*args, chunk=chunk)
            y_r, h_r = ssd_reference(*args)
            check(bool(torch.isfinite(y.float()).all()
                       and torch.isfinite(h).all()), f"ssd {case}: not finite")
            # relative to the output's scale (at least 1): rounding is
            # relative, and at N 128 or with a chunk cut at other points
            # than the plain version's (chunk 192: the kernel's 128 + 64)
            # the f32 outputs reach magnitudes the JAX test's never do
            errs = tuple(_max_err(a, b) / max(1.0, float(b.float().abs()
                                                         .max()))
                         for a, b in ((y, y_p), (h, h_p)))
            check(max(errs) < SSD_TOL[dtype], f"ssd {case} {dtype}: {errs}")
            name = str(dtype).split(".")[-1]
            w = worst.setdefault(name, {"rel_vs_plain": 0.0,
                                        "abs_vs_reference": 0.0})
            if max(errs) >= w["rel_vs_plain"]:
                w["rel_vs_plain"], w["worst_case"] = max(errs), case
            w["abs_vs_reference"] = max(w["abs_vs_reference"],
                                        _max_err(y, y_r), _max_err(h, h_r))
            if case in SSD_F32_CASES:
                long_sums = errs
        if case in SSD_F32_CASES:
            long_secs += time.perf_counter() - t_case
    log("kernel_edges_ssd", cases=len(cases), dtypes=2,
        f32_only_cases=len(SSD_F32_CASES), f32_long_sums_rel=long_sums,
        f32_long_sums_seconds=long_secs, max_err=worst,
        tol={"float32": 2e-5, "bfloat16": 5e-2},
        seconds=time.perf_counter() - t0)


def _ops_rate(dtype, tf32: bool = False) -> float:
    """The peak for ``dtype``'s operations: bf16 on the tensor cores; f32
    on the CUDA cores, or with ``tf32`` (the f32 kernels of flash attention
    and the SSD scan, whose products are 3xTF32) on the tensor cores at
    TF32."""
    if dtype == torch.bfloat16:
        return BF16_TENSOR_OPS_PER_S
    return TF32_TENSOR_OPS_PER_S if tf32 else ALU32_OPS_PER_S


def _bound(nbytes: int, ops: float, dtype, tf32: bool = False) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / _ops_rate(dtype, tf32) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bytes": nbytes, "ops": ops}


def flash_bound(q, k, causal: bool, window) -> dict:
    """Unmasked (query, key) pairs x 4 D operations (2 D for q.k, 2 D for
    p.v); q, k, v read once and o written once. In f32 the operations are
    the kernel's three TF32 products each, over the TF32 tensor rate
    (``alu_bound_ms``: the flops alone over the CUDA cores' f32 rate)."""
    B, Hq, S, D = q.shape
    pos = np.arange(S)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(S, int)
    hi = pos + 1 if causal else np.full(S, S)
    pairs = B * Hq * int((hi - lo).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4.0 * D * pairs
    if q.dtype == torch.bfloat16:
        return _bound(nbytes, flops, q.dtype)
    res = _bound(nbytes, F32_TF32_PRODUCTS * flops, q.dtype, tf32=True)
    res.update(flops=flops, alu_bound_ms=max(
        nbytes / HBM_BYTES_PER_S, flops / ALU32_OPS_PER_S) * 1e3)
    return res


def ssd_bound(x, Bc, chunk: int) -> dict:
    """Per chunk of Q steps with T = Q (Q + 1) / 2 pairs i >= j: C.B^T 2 N T
    a group, and a head 2 P T (scores.x) + 3 T (decay, dt) + 2 Q N P
    (incoming state) + 2 Q N P (state update) + 2 Q P (skip). Bytes: x, dt,
    B, C read once, y and h written once. In f32 the operations are the
    kernels' three TF32 products each, over the TF32 tensor rate
    (``alu_bound_ms``: the flops alone over the CUDA cores' f32 rate)."""
    B, S, H, P = x.shape
    G, N = Bc.shape[2], Bc.shape[3]
    chunk = min(chunk, S)
    while S % chunk:           # the chunk the function runs at
        chunk //= 2
    nc, Q = S // chunk, chunk
    T = Q * (Q + 1) / 2
    ops = B * nc * (G * 2 * N * T + H * (2 * P * T + 3 * T + 4 * Q * N * P
                                         + 2 * Q * P))
    nbytes = 2 * x.numel() * x.element_size() + B * S * H * 4 \
        + 2 * Bc.numel() * Bc.element_size() + B * H * P * N * 4 + 2 * H * 4
    if x.dtype == torch.bfloat16:
        return _bound(nbytes, ops, x.dtype)
    res = _bound(nbytes, F32_TF32_PRODUCTS * ops, x.dtype, tf32=True)
    res.update(flops=ops, alu_bound_ms=max(
        nbytes / HBM_BYTES_PER_S, ops / ALU32_OPS_PER_S) * 1e3)
    return res


def time_flash(q, k, v, *, causal: bool, window, reps: int = 20) -> dict:
    """The flash kernel against its plain version and SDPA, on (B, H, S, D)
    inputs."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reference)
    F = torch.nn.functional
    kw = dict(causal=causal, window=window)
    got = flash_attention(q, k, v, **kw)
    res = {"shape": list(q.shape), "kv_heads": k.shape[1], "causal": causal,
           "window": window, "dtype": str(q.dtype).split(".")[-1],
           "max_abs_err": _max_err(got, reference(q, k, v, **kw))}
    check(res["max_abs_err"] < FA_TOL[q.dtype],
          f"flash at {res['shape']}: {res['max_abs_err']}")
    res["ms"] = cuda_ms(lambda: flash_attention(q, k, v, **kw), reps)
    res["plain_ms"] = cuda_ms(lambda: reference(q, k, v, **kw), 2)
    if window:
        pos = torch.arange(q.shape[2], device=q.device)
        keep = pos[None, :] <= pos[:, None] if causal else \
            torch.ones(q.shape[2], q.shape[2], dtype=torch.bool,
                       device=q.device)
        keep = keep & (pos[:, None] - pos[None, :] < window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=keep, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
    res["library_ms"] = cuda_ms(lib, reps)
    res["library"] = "torch.nn.functional.scaled_dot_product_attention"
    res.update(flash_bound(q, k, causal, window))
    return res


def time_ssd(x, dt, A, Bc, Cc, D, *, chunk: int, reps: int = 20) -> dict:
    """The SSD kernel (one call: its three CUDA kernels) against its plain
    version (no single PyTorch call computes it, so no library time).
    ``ms`` is the time between events around eager calls, as for the other
    kernels: it holds the host's time between the three launches where
    that exceeds the card's. Diagnostics beside it: ``graph_ms``, the
    device time of one call from a CUDA graph of it, replayed, and
    ``phase_ms``, each phase's device time alone, the same way; and the
    scratch states' traffic at the kernel's chunk, which the bound does not
    count (written by phase 1, read and written by phase 2, read by phase
    3: four passes), with its time at the HBM rate."""
    from repro_torch.kernels.ssd_scan.ops import phase_launches, ssd, \
        tile_plan
    from repro_torch.models.ssm import ssd_chunked
    y, h = ssd(x, dt, A, Bc, Cc, D, chunk=chunk)
    y_p, h_p = ssd_chunked(x, dt, A, Bc, Cc, D, chunk=chunk)
    B, S, H, P = x.shape
    res = {"shape": list(x.shape), "groups": Bc.shape[2],
           "state": Bc.shape[3], "chunk": chunk,
           "dtype": str(x.dtype).split(".")[-1],
           "plan": tile_plan(B, S, H, P, Bc.shape[2], Bc.shape[3], x.dtype,
                             chunk),
           "max_abs_err": max(_max_err(y, y_p), _max_err(h, h_p))}
    # bf16: absolute, as on hymba's layer; f32: relative to each output's
    # scale (at least 1), as phase_ssd_edges holds it, since at full width
    # the f32 outputs reach magnitudes where rounding is what differs
    res["max_rel_err"] = max(_max_err(a, b) / max(1.0, float(
        b.float().abs().max())) for a, b in ((y, y_p), (h, h_p)))
    err = res["max_abs_err"] if x.dtype == torch.bfloat16 \
        else res["max_rel_err"]
    check(err < SSD_TOL[x.dtype], f"ssd at {res['shape']} {x.dtype}: {err}")
    call = lambda: ssd(x, dt, A, Bc, Cc, D, chunk=chunk)  # noqa: E731
    res["ms"] = cuda_ms(call, reps)
    res["graph_ms"] = graph_ms(call, reps)
    runs, _, _ = phase_launches(x, dt, A, Bc, Cc, D, chunk)
    res["phase_ms"] = {name: graph_ms(run, reps) for name, run in runs}
    res["plain_ms"] = cuda_ms(
        lambda: ssd_chunked(x, dt, A, Bc, Cc, D, chunk=chunk), 2)
    res["library_ms"] = None
    res.update(ssd_bound(x, Bc, chunk))
    res["scratch_traffic_bytes"] = 4 * res["plan"]["scratch_bytes"]
    res["scratch_traffic_ms"] = \
        res["scratch_traffic_bytes"] / HBM_BYTES_PER_S * 1e3
    return res


def phase_seeded_shapes(dev) -> dict:
    """The kernels at the widths of the repo's other models: yi-6b's
    attention (causal, no window) in bf16 and in f32 (the 3xTF32 kernel,
    SDPA in f32 beside it; TF32 is off), the f32 kernel again at
    hymba-1.5b's (window 2048), and the SSD scan at mamba2-130m's shape (N
    128) in bf16, and in f32 there and at hymba-1.5b's (N 16)."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(5)
    flash = {}
    for name, dtype, (B, Hq, KVH, S, D, win), reps in (
            ("yi-6b", torch.bfloat16, (1, 32, 4, 4096, 128, None), 20),
            ("yi-6b", torch.float32, (1, 32, 4, 4096, 128, None), 10),
            ("hymba-1.5b", torch.float32, (2, 25, 5, 4096, 64, 2048), 10)):
        q, k, v = _flash_inputs(g, B, Hq, KVH, S, D, dtype, dev)
        flash[name, dtype] = time_flash(q, k, v, causal=True, window=win,
                                        reps=reps)
        flash[name, dtype]["model"] = name
        log("kernel_seeded_flash", **flash[name, dtype])
        del q, k, v
        torch.cuda.empty_cache()
    scans = {}
    for name, dtype, (B, S, H, P, G, N) in (
            ("mamba2-130m", torch.bfloat16, (2, 4096, 24, 64, 1, 128)),
            ("mamba2-130m", torch.float32, (2, 4096, 24, 64, 1, 128)),
            ("hymba-1.5b", torch.float32, (2, 4096, 25, 64, 1, 16))):
        args = _ssd_inputs_seeded(g, B, S, H, P, G, N, 1.0, dtype, dev)
        scans[name, dtype] = time_ssd(*args, chunk=128)
        scans[name, dtype]["model"] = name
        log("kernel_seeded_ssd", **scans[name, dtype])
        del args
        torch.cuda.empty_cache()
    out = {"flash": flash["yi-6b", torch.bfloat16],
           "flash_f32": flash["yi-6b", torch.float32],
           "flash_f32_hymba": flash["hymba-1.5b", torch.float32],
           "ssd": scans["mamba2-130m", torch.bfloat16],
           "ssd_f32": scans["mamba2-130m", torch.float32],
           "ssd_f32_hymba": scans["hymba-1.5b", torch.float32]}
    log("kernel_seeded", seconds=time.perf_counter() - t0,
        shapes=[f"{k} {v['model']} {v['dtype']}" for k, v in out.items()])
    return out


def phase_reference_check(dev) -> None:
    """The port's models on the card against the same models on the CPU, on
    a small f32 input, every arch of the registry at its smoke config (the
    CPU path is held against the JAX package by the tests). TF32 is off for
    f32 matmuls here and below."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import init_params, prefill
    from repro_torch.serve import Engine
    errs = {}
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                             compute_dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (2, 24)))
        with torch.inference_mode():
            _, cpu_logits = prefill(cfg, params, toks)
            _, dev_logits = prefill(cfg, _to(params, dev), toks.to(dev))
        err = float((dev_logits.cpu() - cpu_logits).abs().max())
        check(err <= 1e-4, f"{arch}: f32 prefill logits, card vs CPU: "
              f"{err} > 1e-4")
        prompts = toks.numpy().astype(np.int32)
        t_cpu = Engine(cfg, params, max_len=40, device="cpu").generate(
            prompts, 8)
        t_dev = Engine(cfg, params, max_len=40, device=dev).generate(
            prompts, 8)
        check(np.array_equal(t_cpu.tokens, t_dev.tokens),
              f"{arch}: greedy tokens differ between card and CPU")
        errs[arch] = err
    train = _train_step_card_vs_cpu(dev)
    log("reference_check", prefill_max_abs_err=errs, tol=1e-4,
        tokens_equal=True, train_step=train)


MOE_TOL = 1e-4     # f32 moe_ffn, card against CPU (TF32 off)


def phase_moe_dispatch(dev) -> list:
    """``moe_ffn`` at full width on layer 0 of mixtral-8x7b (8 experts,
    top-2, expert d_ff 14336) and one layer of granite-moe-3b-a800m (40
    experts, top-8, expert d_ff 512), f32 weights drawn on the card as the
    moe block draws them, at a prefill's T (4 x 128 tokens) and a decode
    step's (4), on the card and on the CPU: ``dispatch_indices``' slot,
    keep and token must be identical and the outputs within ``MOE_TOL``.
    The drops are logged: at decode the capacity is 1, so most of a step's
    assignments drop, as in the reference."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import init_moe_block
    from repro_torch.models.moe import dispatch_indices, moe_ffn, route
    rows = []
    for arch in ("mixtral-8x7b", "granite-moe-3b-a800m"):
        cfg = get_config(arch).replace(param_dtype="float32")
        g = torch.Generator(device=dev).manual_seed(7)
        block = init_moe_block(cfg, g, dev, 1)
        weights = {k: block[k][0] for k in ("router", "w_gate", "w_up",
                                             "w_down")}
        del block
        on_cpu = {k: v.cpu() for k, v in weights.items()}
        E, k = cfg.n_experts, cfg.top_k
        for T in (4 * 128, 4):
            x = torch.randn((T, cfg.d_model), generator=g, device=dev)
            capacity = max(1, int(T * k * cfg.capacity_factor / E))
            got = {}
            for where, xx, w in (("card", x, weights),
                                 ("cpu", x.cpu(), on_cpu)):
                with torch.inference_mode():
                    _, experts, _ = route(xx, w["router"], k)
                    idx = dispatch_indices(experts, E, capacity)
                    y, aux = moe_ffn(xx, w["router"], w["w_gate"], w["w_up"],
                                     w["w_down"], top_k=k,
                                     capacity_factor=cfg.capacity_factor,
                                     act=cfg.act)
                got[where] = ([t.cpu() for t in idx], y.cpu(), float(aux))
            (i_dev, y_dev, a_dev), (i_cpu, y_cpu, a_cpu) = got["card"], \
                got["cpu"]
            check(all(torch.equal(a, b) for a, b in zip(i_dev, i_cpu)),
                  f"{arch} T {T}: slot, keep or token differ, card vs CPU")
            err = float((y_dev - y_cpu).abs().max())
            check(err <= MOE_TOL, f"{arch} T {T}: moe_ffn card vs CPU "
                  f"{err} > {MOE_TOL}")
            check(abs(a_dev - a_cpu) <= 1e-5, f"{arch} T {T}: aux "
                  f"{a_dev} != {a_cpu}")
            keep = i_cpu[1]
            row = dict(model=arch, T=T, experts=E, top_k=k,
                       capacity=capacity, assignments=T * k,
                       dropped=int((~keep).sum()), max_abs_err=err,
                       tol=MOE_TOL, aux=a_cpu, dispatch_equal=True)
            rows.append(row)
            log("moe_dispatch", **row)
        del weights, on_cpu
        torch.cuda.empty_cache()
    return rows


def _train_step_card_vs_cpu(dev) -> dict:
    """One train step of yi-6b's smoke config in f32 (TF32 off), on the card
    against the CPU from the same weights and batch, with the tolerances of
    the CPU parity tests (tests/test_torch_train.py): the loss within 1e-5;
    each grad leaf within 1e-4 x max(1, max |g|); AdamW from identical
    grads (the CPU's) within 1e-6 relative (max |card - cpu| over max
    |cpu|) for master, m, v, lr and the grad norm; the whole step's master,
    m and v within the grads' 1e-4 x max(1, max |x|). A whole step is not
    held to 1e-6: Adam's first update is lr g / (|g| + eps), which moves by
    up to 2 lr where |g| is near eps and the two devices' sums round g
    apart."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, apply_update, init_opt_state
    from repro_torch.train.step import value_and_grad
    cfg = get_smoke_config("yi-6b").replace(param_dtype="float32",
                                            compute_dtype="float32")
    acfg = AdamWConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=200,
                       weight_decay=0.0)
    batch = SyntheticTokens(cfg.vocab, 4, 64, seed=0).batch_at(0)
    host = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    runs = []
    for where in ("cpu", dev):
        params = _to(_clone(host), where)
        loss, _, grads = value_and_grad(
            cfg, params, {k: torch.as_tensor(v, device=where)
                          for k, v in batch.items()})
        runs.append((params, float(loss), grads))
    (p_cpu, loss_cpu, g_cpu), (p_dev, loss_dev, g_dev) = runs
    err = {"loss": abs(loss_dev - loss_cpu),
           "grads": max(float((a.cpu() - b).abs().max())
                        / max(1.0, float(b.abs().max()))
                        for a, b in zip(g_dev, g_cpu))}
    same = apply_update(acfg, _clone(p_dev), init_opt_state(p_dev),
                        [g.to(dev) for g in g_cpu])
    want = apply_update(acfg, p_cpu, init_opt_state(p_cpu), g_cpu)
    step = apply_update(acfg, p_dev, init_opt_state(p_dev), g_dev)

    def worst(got, ref, k, floor):
        a, b = _flat(got[1][k]), _flat(ref[1][k])
        return max(float((a[n].cpu() - b[n]).abs().max())
                   / max(floor, float(b[n].abs().max())) for n in b)

    for k in ("lr", "grad_norm"):
        err[f"same_grads_{k}"] = float((same[2][k].cpu() - want[2][k]).abs()
                                       / want[2][k].abs())
    for k in ("master", "m", "v"):
        err[f"same_grads_{k}"] = worst(same, want, k, 1e-30)
        err[f"step_{k}"] = worst(step, want, k, 1.0)
    tol = {"loss": 1e-5, "grads": 1e-4,
           **{f"same_grads_{k}": 1e-6
              for k in ("lr", "grad_norm", "master", "m", "v")},
           **{f"step_{k}": 1e-4 for k in ("master", "m", "v")}}
    for k, t in tol.items():
        check(err[k] <= t, f"train step card vs CPU, {k}: {err[k]} > {t}")
    return {"err": err, "tol": tol, "loss": loss_cpu}


def phase_kernel_path(cfg, params, prompts, dev) -> dict:
    """The flash attention and SSD scan entry points, driven on the tensors
    the served hybrid model's prefill computes in every layer (q, k, v
    after RoPE through the port's own ``_qkv``; x, dt, A, Bc, Cc, D through
    the first half of its ``apply_ssm_core``), each output held against the
    model's own ``attention`` / ``ssd_chunked`` result on the same tensors.
    The model itself calls neither kernel, as in the JAX package. Launches
    are counted from here to the end of the layer loop. Returns the counts,
    the errors and layer 0's tensors."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.models.attention import attention
    from repro_torch.models.blocks import (_qkv, _repeat_kv,
                                           apply_hybrid_block,
                                           ssm_scan_inputs)
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import _unstack, embed_tokens
    from repro_torch.models.ssm import ssd_chunked
    toks = torch.as_tensor(prompts, device=dev).long()
    B, S = toks.shape
    positions = torch.arange(S, device=dev).expand(B, S)
    rep = cfg.n_heads // cfg.n_kv_heads
    err = {"flash_vs_model": 0.0, "ssd_y_vs_model": 0.0,
           "ssd_h_vs_model": 0.0}
    layer0 = None
    t0 = time.perf_counter()
    flash_attention.launches = 0
    ssd.launches = 0
    ssd.kernel_launches = dict.fromkeys(ssd.kernel_launches, 0)
    with torch.inference_mode():
        x = embed_tokens(cfg, params, toks)
        for i, p in enumerate(_unstack(params["blocks"])):
            h = rms_norm(x, p["norm"], cfg.rms_eps)
            q, k, v = _qkv(cfg, p["attn"], h, positions)
            _, _, scan = ssm_scan_inputs(cfg, p["ssm"], h)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            o = flash_attention(qt, kt, vt, causal=True, window=cfg.window)
            y, hs = ssd(**scan, chunk=cfg.ssm_chunk)
            o_model = attention(q, _repeat_kv(k, rep), _repeat_kv(v, rep),
                                causal=True, window=cfg.window,
                                impl=cfg.attn_impl, kv_block=cfg.kv_block,
                                q_block=cfg.q_block,
                                score_dtype=cfg.score_dtype)
            y_model, h_model = ssd_chunked(**scan, chunk=cfg.ssm_chunk)
            err["flash_vs_model"] = max(err["flash_vs_model"], _max_err(
                o.transpose(1, 2), o_model))
            err["ssd_y_vs_model"] = max(err["ssd_y_vs_model"],
                                        _max_err(y, y_model))
            err["ssd_h_vs_model"] = max(err["ssd_h_vs_model"],
                                        _max_err(hs, h_model))
            if i == 0:
                layer0 = {"qkv": (qt, kt, vt), "scan": scan}
            x, _, _ = apply_hybrid_block(cfg, p, x, positions)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd.launches}
    cuda_kernels = dict(ssd.kernel_launches)
    dtype = params["embed"].dtype
    check(err["flash_vs_model"] < FA_TOL[dtype],
          f"flash kernel vs the model's attention: {err['flash_vs_model']}")
    check(max(err["ssd_y_vs_model"], err["ssd_h_vs_model"]) < SSD_TOL[dtype],
          f"ssd kernel vs the model's ssd_chunked: {err}")
    check(launches == {"flash_attention": cfg.n_layers,
                       "ssd_scan": cfg.n_layers},
          f"kernel launches on the path: {launches}")
    check(cuda_kernels == dict.fromkeys(cuda_kernels, cfg.n_layers),
          f"the SSD scan's CUDA kernels on the path: {cuda_kernels}")
    log("kernel_path", seconds=time.perf_counter() - t0, layers=cfg.n_layers,
        batch=B, prompt_len=S, launches=launches,
        ssd_cuda_kernels=cuda_kernels, max_abs_err=err,
        tol={"flash": FA_TOL[dtype], "ssd": SSD_TOL[dtype]})
    return {"launches": launches, "ssd_cuda_kernels": cuda_kernels,
            "err": err, "layer0": layer0}


def phase_kernel_full(layer0, cfg) -> dict:
    """Both kernels timed on layer 0's tensors of the served prefill."""
    qt, kt, vt = layer0["qkv"]
    flash = time_flash(qt, kt, vt, causal=True, window=cfg.window)
    scan = time_ssd(**layer0["scan"], chunk=cfg.ssm_chunk)
    flash["model"] = scan["model"] = cfg.name
    log("kernel_full", flash=flash, ssd=scan)
    return {"flash": flash, "ssd": scan}


def _edit_leaf(params, path: str, layer: int):
    """A copy-on-write copy of ``params`` in which layer ``layer`` of the
    leaf at ``path`` (e.g. "blocks/ssm/w_x") moves by 0.01 -> (new params,
    the edited leaf)."""
    parts = path.split("/")
    new = dict(params)
    node, src = new, params
    for p in parts[:-1]:
        src = src[p]
        node[p] = dict(src)
        node = node[p]
    leaf = src[parts[-1]].clone()
    leaf[layer] += 0.01
    node[parts[-1]] = leaf
    return new, leaf


def _blob_set(store, image: str, tag: str) -> set:
    manifest, _ = store.read_image(image, tag)
    return {h for lid in manifest.layer_ids
            for r in store.read_layer(lid).records for h in r.chunks}


def _pull_log(pull) -> dict:
    return {k: getattr(pull, k) for k in (
        "blobs_sent", "blobs_dedup", "layers_sent", "bytes_sent",
        "bytes_payload", "bytes_meta", "layers_deep_verified",
        "layers_rekey_verified", "blobs_hashed_remote")}


def serving_path(cfg, params, dev, chunk_bytes: int, batch: int,
                 prompt_len: int, new_tokens: int, edit: str,
                 edit_layer: int, follower: str, extras=()) -> dict:
    """The main path through the entry points a user calls:

        save -> follower poll -> engine + serve -> incremental save
        -> follower poll_and_refresh -> serve

    ``follower="smart"`` pulls from the trainer's store (one have-set
    negotiation, only missing chunks); ``"passive"`` has no live peer and
    applies the bundles the manager publishes into a registry directory,
    with no negotiation. Between the saves, layer ``edit_layer`` of the
    leaf ``edit`` and ``final_norm`` change on the device, and the update
    must name exactly those two leaves. ``extras`` adds the store's
    sub-paths on the same stores: "fp_per_leaf", "fp_tree" and "specs"
    before the main path; after it, "repair" (a smart follower's verify
    gate catches a blob rotted at rest in the replica and heals it from
    the trainer's store), "tenants" (tenants and ``replicate``), "scrub"
    (a passive follower's replica), then "steps" (the prefill and decode
    step bundles on the served engine) and "sample" (sampled decoding;
    needs "steps"). Returns the counts the caller checks against the
    kernels, the engine and the prompts."""
    from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
    from repro_torch.core import tree_pack_index
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serve import CheckpointFollower, Engine

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    rep = tempfile.mkdtemp(prefix="chip_smoke_replica_")
    reg = tempfile.mkdtemp(prefix="chip_smoke_registry_")
    smart = follower == "smart"
    try:
        policy = CheckpointPolicy(use_fingerprints=True,
                                  chunk_bytes=chunk_bytes, async_write=False)
        mgr = CheckpointManager(tmp, cfg.name, policy,
                                registry=None if smart else reg)
        union = {}
        for tree in mgr._payloads(params, {}, 0).values():
            union.update(tree)
        _, total_chunks, _ = tree_pack_index(union, chunk_bytes)
        if dev.type == "cuda":
            out["kernel"] = phase_fingerprint_full(union, chunk_bytes)
            if "fp_per_leaf" in extras:
                out["fp_per_leaf"] = phase_fp_per_leaf(union, chunk_bytes)
            if "fp_tree" in extras:
                out["fp_tree"] = phase_fp_tree(union, chunk_bytes)
        if "specs" in extras:
            out["specs"] = phase_specs(cfg, params)

        # ---- the main path: launches are counted from here to the refresh
        fingerprint_leaves.launches = 0
        t0 = time.perf_counter()
        r0 = mgr.save(0, params, {})
        log("save", seconds=time.perf_counter() - t0,
            chunks_written=r0.chunks_written, bytes_hashed=r0.bytes_hashed,
            bytes_d2h=r0.bytes_d2h, layers_built=r0.layers_built,
            fp_launches=fingerprint_leaves.launches,
            param_bytes=_nbytes(params), total_chunks=total_chunks)
        check(r0.layers_built == 6, "full save did not build 6 layers")
        check(mgr.store.verify_image(mgr.image, mgr.tag_of(0), deep=False)
              == [], "full save fails verification")
        check(smart or mgr.last_publish_error is None,
              f"publish failed: {mgr.last_publish_error}")

        fol = CheckpointFollower(remote=mgr.store if smart else None,
                                 local=rep, registry=None if smart else reg)
        t0 = time.perf_counter()
        upd0 = fol.poll()
        pull_s = time.perf_counter() - t0
        check(upd0 is not None and upd0.full and upd0.step == 0,
              "the first poll is not a full update of step 0")
        check(upd0.tensors_loaded == len(union),
              f"first poll loaded {upd0.tensors_loaded} of {len(union)}")
        check(all(t.device.type == "cpu" for t in _flat(upd0.params).values()),
              "poll returned tensors off the host")
        if smart:
            check(fol.last_pull.blobs_sent == r0.chunks_written,
                  "the first pull did not send every blob")
            pull = _pull_log(fol.last_pull)
        else:
            plan = fol.last_plan
            check(plan.negotiations == 0 and plan.hops == 1
                  and plan.edges_skipped == 0, f"passive plan {plan}")
            pull = dataclasses.asdict(plan)
        log("pull", follower=follower, seconds=pull_s, **pull)
        prompts = make_prompts(cfg, batch, prompt_len)
        eng, res, gen_s = serve(cfg, upd0.params, prompts, new_tokens, dev)
        flat_e, flat_p = _flat(eng.params), _flat(params)
        check(sorted(flat_e) == sorted(flat_p) and all(
            torch.equal(flat_e[k], flat_p[k]) for k in flat_p),
            "the pulled weights differ from the saved ones")
        del upd0
        check(res.tokens.shape == (batch, new_tokens), "wrong token shape")
        check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
              "token out of range")
        check(bool(np.isfinite(res.logits_last).all()), "non-finite logits")
        log("serve", seconds=gen_s, batch=batch, prompt_len=prompt_len,
            new_tokens=new_tokens, tokens_per_s=res.tokens.size / gen_s,
            first_tokens=res.tokens[0, :8].tolist())

        # a few leaves change on the device: one layer of ``edit``, and
        # final_norm
        layer = edit_layer
        check(layer < cfg.n_layers, f"edit layer {layer} of {cfg.n_layers}")
        params1, leaf = _edit_leaf(params, edit, layer)
        params1["final_norm"] = params["final_norm"] * 1.5
        layer_bytes = leaf[layer].numel() * leaf.element_size()
        first, last = layer * layer_bytes, (layer + 1) * layer_bytes - 1
        # chunks that changed: the layer's, final_norm's and the step's
        expect_chunks = last // chunk_bytes - first // chunk_bytes + 1 + 1 + 1
        n0 = fingerprint_leaves.launches
        t0 = time.perf_counter()
        r1 = mgr.save(1, params1, {})
        out["save2_launches"] = fingerprint_leaves.launches - n0
        log("save2", seconds=time.perf_counter() - t0,
            fp_launches=out["save2_launches"], bytes_d2h=r1.bytes_d2h,
            total_chunks=total_chunks, chunks_written=r1.chunks_written,
            chunks_prefiltered=r1.chunks_prefiltered,
            layers_injected=r1.layers_injected, layers_built=r1.layers_built,
            bytes_serialized=r1.bytes_serialized)
        check(r1.bytes_d2h == 8 * total_chunks,
              f"bytes_d2h {r1.bytes_d2h} != 8 x {total_chunks}")
        check(r1.layers_built == 0 and r1.layers_injected == 3,
              "incremental save fell back to a rebuild")
        check(r1.chunks_written == expect_chunks,
              f"wrote {r1.chunks_written} chunks, {expect_chunks} changed")
        # the prefilter counts the chunks of the layers that changed (all
        # but the embedding) it proved unchanged
        _, embed_chunks, _ = tree_pack_index(
            {k: v for k, v in union.items() if k.startswith("params/embed")},
            chunk_bytes)
        check(r1.chunks_prefiltered
              == total_chunks - embed_chunks - expect_chunks,
              "prefilter count is off")
        check(mgr.store.verify_image(mgr.image, mgr.tag_of(1)) == [],
              "incremental save fails verification")
        written = _blob_set(mgr.store, mgr.image, mgr.tag_of(1)) - \
            _blob_set(mgr.store, mgr.image, mgr.tag_of(0))
        written_bytes = sum(os.path.getsize(mgr.store._blob_path(h))
                            for h in written)
        check(len(written) == r1.chunks_written, "new blobs != chunks written")

        t0 = time.perf_counter()
        upd1 = fol.poll_and_refresh(eng)
        refresh_s = time.perf_counter() - t0
        res2 = eng.generate(prompts, new_tokens)
        out["launches"] = fingerprint_leaves.launches
        # ---- end of the main path
        check(upd1 is not None and upd1.step == 1, "no update of step 1")
        check(upd1.changed_params == {edit, "final_norm"},
              f"sparse plan {upd1.changed_params}")
        check(upd1.tensors_loaded == 3, "the update loaded extra tensors "
              f"({upd1.tensors_loaded}; want the 2 leaves and opt/__step__)")
        check(eng.last_refresh_leaves == 2, "the engine swapped "
              f"{eng.last_refresh_leaves} leaves, not 2")
        if smart:
            wire = fol.last_pull
            check(wire.blobs_sent == r1.chunks_written
                  and wire.bytes_payload == written_bytes,
                  f"pulled {wire.blobs_sent} blobs / {wire.bytes_payload} B;"
                  f" the save wrote {r1.chunks_written} / {written_bytes} B")
            pull = _pull_log(wire)
        else:
            check(fol.last_plan.negotiations == 0, "passive pull negotiated")
            pull = dataclasses.asdict(fol.last_plan)
        health = fol.health()
        check(health.polls == 2 and health.failures == 0,
              f"follower health {health}")
        check(fol.poll() is None, "a third poll found an update")
        res_ref = Engine(cfg, params1, max_len=eng.max_len,
                         device=dev).generate(prompts, new_tokens)
        check(np.array_equal(res2.tokens, res_ref.tokens),
              "tokens after the sparse refresh differ from a direct engine")
        log("refresh", follower=follower, seconds=refresh_s,
            changed=sorted(upd1.changed_params),
            tensors_loaded=upd1.tensors_loaded,
            leaves_swapped=eng.last_refresh_leaves, tokens_equal=True,
            written_chunks=r1.chunks_written, written_bytes=written_bytes,
            tokens_moved=int((res2.tokens != res.tokens).sum()), **pull)

        if "repair" in extras:
            out["repair"] = _verify_and_repair(cfg, mgr, fol, eng, params,
                                               edit, prompts, new_tokens, res)
        if "tenants" in extras:
            out.update(_tenants_and_replicate(cfg, mgr, fol, params, dev,
                                              prompts, new_tokens))
        if "scrub" in extras:
            out["scrub"] = _scrub_and_heal(cfg, mgr, fol, dev, prompts,
                                           new_tokens, res_ref.tokens)
        if "steps" in extras:
            out["steps"] = phase_steps(cfg, eng, prompts, new_tokens)
        if "sample" in extras:
            st = out["steps"]
            out["sample"] = phase_sample(cfg, eng, prompts, new_tokens,
                                         st.pop("greedy"), st.pop("gaps"))

        with torch.inference_mode():
            toks = torch.as_tensor(prompts, device=dev).long()
            pf_ms = _host_ms(lambda: prefill(cfg, eng.params, toks), 3, dev)
            cache = init_cache(cfg, batch, eng.max_len, dev)
            tok = toks[:, -1]
            step = lambda: decode_step(cfg, eng.params, cache, tok, prompt_len)
            dec_ms = _host_ms(step, 5, dev)
            dec_ops = _count_ops(step)
        log("split", model=cfg.name, prefill_ms=pf_ms, decode_step_ms=dec_ms,
            batch=batch, prompt_len=prompt_len, decode_step_ops=dec_ops,
            ms_per_op=dec_ms / dec_ops)
    finally:
        for d in (tmp, rep, reg):
            shutil.rmtree(d, ignore_errors=True)
    out.update(engine=eng, prompts=prompts)
    return out


def _verify_and_repair(cfg, mgr, fol, eng, params, edit, prompts,
                       new_tokens, res0) -> dict:
    """save(2) puts the first weights back, so the chunks the update needs
    are ones the replica still holds for step 0 and the pull does not send
    them again. One of them is rotted at rest in the replica first: the
    follower's verify gate must catch it, ``repair_image`` must heal it
    from the trainer's store, and the engine must serve step 0's tokens."""
    mgr.save(2, params, {})
    stale = (_blob_set(fol.local, fol.image, mgr.tag_of(0))
             & _blob_set(mgr.store, mgr.image, mgr.tag_of(2))) - \
        _blob_set(fol.local, fol.image, mgr.tag_of(1))
    victim = sorted(stale)[0]
    path = fol.local._blob_path(victim)
    with open(path, "r+b") as f:
        byte = f.read(1)
        f.seek(0)
        f.write(bytes([byte[0] ^ 0xFF]))
    t0 = time.perf_counter()
    upd = fol.poll_and_refresh(eng)
    seconds = time.perf_counter() - t0
    health = fol.health()
    check(upd is not None and upd.step == 2,
          f"the rotted revision was not applied: {fol.last_verify_error}")
    check(health.corrupt_polls == 1 and health.repairs == 1,
          f"verify gate and repair: {health}")
    check(upd.changed_params == {edit, "final_norm"}
          and eng.last_refresh_leaves == 2, "repair poll swapped other leaves")
    check(fol.local.verify_image(fol.image, mgr.tag_of(2), deep=False)
          == [], "the replica does not verify after the repair")
    res = eng.generate(prompts, new_tokens)
    check(np.array_equal(res.tokens, res0.tokens),
          "tokens after the repair differ from step 0's")
    out = dict(seconds=seconds, corrupt_polls=health.corrupt_polls,
               repairs=health.repairs, stale_blobs=len(stale),
               blobs_sent=fol.last_pull.blobs_sent,
               bytes_payload=fol.last_pull.bytes_payload, tokens_equal=True)
    log("repair", **out)
    return out


# the tenants of examples/serve_multitenant.py: (edited leaf, edit)
TENANT_DELTAS = (
    ("final_norm", lambda p: p["final_norm"] * 2.0),
    ("embed", lambda p: p["embed"] + 0.5 * torch.sign(p["embed"])),
    ("final_norm", lambda p: p["final_norm"] * 0.5),
)


def _store_blobs(store) -> dict:
    """{content address: payload bytes} of every blob file on disk."""
    out = {}
    for d, _, files in os.walk(os.path.join(store.root, "blobs", "sha256")):
        for fn in files:
            out[fn] = os.path.getsize(os.path.join(d, fn))
    return out


def _layer_chunks(store, lid: str) -> set:
    return {h for r in store.read_layer(lid).records for h in r.chunks}


def _tenants_and_replicate(cfg, mgr, fol, params, dev, prompts,
                           new_tokens) -> dict:
    """Phases ``tenants`` and ``replicate`` on the trainer's store.

    Three tenant managers share the trainer's store and fork their first
    save from its step 0 (``base_image=``), with the edits of
    ``TENANT_DELTAS`` made on the card. A ``final_norm`` tenant reuses the
    base's FROM, embed and blocks layers by id; the ``embed`` tenant misses
    at embed, so by the DLC fall-through rule its blocks layer is rebuilt
    under a new id from chunks the store already holds (no new blob). The
    third tenant saves once more, incrementally, through the per-leaf
    fingerprints (one launch per leaf). Then ``replicate`` fans each
    tenant's step 0 to the follower's replica and to a second replica
    seeded with the base: one negotiation round a fan, and each replica
    receives exactly the payload of the tenant's chunks it lacks. Two
    tenants restored from the second replica give a direct engine's
    tokens."""
    from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
    from repro_torch.core import LayerStore, push_delta
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.serve import Engine

    store, cb = mgr.store, mgr.store.chunk_bytes
    base = (mgr.image, mgr.tag_of(0))
    base_m, _ = store.read_image(*base)
    base_chunks = _blob_set(store, *base)
    tenants, logs = [], []
    fingerprint_leaves.launches = 0
    for i, (leaf, fn) in enumerate(TENANT_DELTAS, start=1):
        variant = dict(params)
        variant[leaf] = fn(params)
        policy = CheckpointPolicy(use_fingerprints=True, chunk_bytes=cb,
                                  async_write=False,
                                  packed_fingerprints=i != 3)
        tm = CheckpointManager("", cfg.name, policy, image=f"tenant{i}",
                               base_image=base, store=store)
        before, n0 = _store_blobs(store), fingerprint_leaves.launches
        t0 = time.perf_counter()
        rep = tm.save(0, variant, {})
        seconds = time.perf_counter() - t0
        after = _store_blobs(store)
        new = set(after) - set(before)
        m, _ = store.read_image(tm.image, tm.tag_of(0))
        edited = 1 if leaf == "embed" else 3      # the layer the edit is in
        reused = [a == b for a, b in zip(m.layer_ids, base_m.layer_ids)]
        check(reused == [True] * edited + [False] * (6 - edited)
              and rep.layers_cached == edited,
              f"tenant{i}: layers reused {reused}, cached "
              f"{rep.layers_cached}")
        check(new and new <= _layer_chunks(store, m.layer_ids[edited]),
              f"tenant{i}: new blobs outside its edited layer")
        blocks_new = _layer_chunks(store, m.layer_ids[2]) & new
        check(not blocks_new, f"tenant{i}: the blocks layer added blobs")
        row = dict(tenant=f"tenant{i}", edit=leaf, seconds=seconds,
                   layers_cached=rep.layers_cached,
                   layers_built=rep.layers_built,
                   blocks_rebuilt=not reused[2],
                   blocks_new_blobs=len(blocks_new),
                   blobs_added=len(new),
                   bytes_added=sum(after[h] for h in new),
                   chunks_written=rep.chunks_written,
                   fp_launches=fingerprint_leaves.launches - n0,
                   packed_fingerprints=policy.packed_fingerprints)
        logs.append(row)
        log("tenants", **row)
        tenants.append((tm, variant))

    # a second, incremental save of the per-leaf tenant
    tm, variant = tenants[2]
    variant1 = dict(variant, final_norm=variant["final_norm"] * 0.25)
    n_leaves = sum(len(t) for t in tm._payloads(variant1, {}, 1).values())
    n0 = fingerprint_leaves.launches
    t0 = time.perf_counter()
    r1 = tm.save(1, variant1, {})
    inc = dict(seconds=time.perf_counter() - t0,
               fp_launches=fingerprint_leaves.launches - n0, leaves=n_leaves,
               bytes_d2h=r1.bytes_d2h, chunks_written=r1.chunks_written,
               layers_injected=r1.layers_injected)
    check(inc["fp_launches"] == n_leaves,
          f"per-leaf incremental save: {inc['fp_launches']} launches for "
          f"{n_leaves} leaves")
    check(r1.layers_built == 0 and r1.layers_injected >= 1,
          "the per-leaf incremental save did not inject")
    log("tenants", incremental_per_leaf=inc)
    tenant_launches = fingerprint_leaves.launches

    # ---- replicate: the follower's replica, and one seeded with the base
    fingerprint_leaves.launches = 0
    replica, rep2_dir = fol.local, tempfile.mkdtemp(prefix="chip_smoke_r2_")
    out = {}
    try:
        replica2 = LayerStore(rep2_dir, chunk_bytes=cb)
        t0 = time.perf_counter()
        seed = push_delta(store, replica2, *base)
        log("replicate", seed_seconds=time.perf_counter() - t0,
            seed_blobs=seed.blobs_sent, seed_bytes=seed.bytes_sent)
        fans = []
        for tm, _ in tenants:
            chunks = _blob_set(store, tm.image, tm.tag_of(0))
            sizes = {h: os.path.getsize(store._blob_path(h)) for h in chunks}
            lack = [sum(sizes[h] for h in chunks if not r.has_blob(h))
                    for r in (replica, replica2)]
            t0 = time.perf_counter()
            fan = tm.replicate(remote=[replica, replica2], step=0)
            seconds = time.perf_counter() - t0
            check(fan.ok and fan.negotiation_rounds == 1,
                  f"{tm.image}: fan ok={fan.ok} rounds="
                  f"{fan.negotiation_rounds}")
            paid = [r.stats.bytes_payload for r in fan.replicas]
            check(paid == lack, f"{tm.image}: payload {paid} != the bytes "
                  f"each replica lacked {lack}")
            check(lack[1] == sum(sizes[h] for h in chunks - base_chunks),
                  f"{tm.image}: the seeded replica lacked more than the "
                  "chunks the base lacks")
            for r in (replica, replica2):
                check(r.verify_image(tm.image, tm.tag_of(0), deep=False)
                      == [], f"{tm.image} does not verify at {r.root}")
            row = dict(tenant=tm.image, seconds=seconds,
                       rounds=fan.negotiation_rounds,
                       source_blob_reads=fan.source_blob_reads,
                       bytes_payload=paid,
                       bytes_sent=[r.stats.bytes_sent for r in fan.replicas],
                       lacked=lack)
            fans.append(row)
            log("replicate", **row)
        served = []
        for tm, variant in tenants[:2]:
            t0 = time.perf_counter()
            got = CheckpointManager("", cfg.name, image=tm.image,
                                    store=replica2).restore(0, device=dev)
            restore_s = time.perf_counter() - t0
            toks = Engine(cfg, got[0], max_len=prompts.shape[1] + new_tokens
                          + 8, device=dev).generate(prompts, new_tokens)
            del got
            want = Engine(cfg, variant, max_len=prompts.shape[1] + new_tokens
                          + 8, device=dev).generate(prompts, new_tokens)
            check(np.array_equal(toks.tokens, want.tokens),
                  f"{tm.image} served from the replica != a direct engine")
            served.append(dict(tenant=tm.image, restore_seconds=restore_s,
                               tokens_equal=True,
                               first_tokens=toks.tokens[0, :8].tolist()))
            log("replicate", **served[-1])
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        out["replicate"] = dict(fans=fans, served=served,
                                launches=fingerprint_leaves.launches)
    finally:
        shutil.rmtree(rep2_dir, ignore_errors=True)
    out["tenants"] = dict(saves=logs, incremental=inc,
                          launches=tenant_launches)
    return out


def _first_reference(store, h: str) -> tuple:
    """The (image, tag, layer) the scrub attributes blob ``h`` to: the
    first that references it, images and tags in sorted order."""
    for name in store.list_images():
        for tag in store.list_tags(name, fresh=True):
            manifest, _ = store.read_image(name, tag)
            for lid in manifest.layer_ids:
                if h in _layer_chunks(store, lid):
                    return name, tag, lid
    return ()


def _scrub_and_heal(cfg, mgr, fol, dev, prompts, new_tokens,
                    want_tokens) -> dict:
    """Phase ``scrub`` on the passive follower's replica: a full pass finds
    nothing; one committed blob of the head is then rotted at rest, and
    sliced passes of 256 MiB, run until the cursor wraps, find exactly that
    blob, attributed to the first (image, tag, layer) that references it.
    ``repair_image`` heals it from the trainer's store, a further full
    pass is clean, and the head restores to the direct engine's tokens."""
    from repro_torch.ckpt.manager import unflatten_tree
    from repro_torch.core import repair_image
    from repro_torch.ft import ScrubReport, inject_bitrot
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.serve import Engine

    replica, head = fol.local, mgr.tag_of(1)
    fingerprint_leaves.launches = 0
    passes = []

    def note(kind, rep):
        passes.append(dict(kind=kind, seconds=rep.wall_s,
                           bytes_scanned=rep.bytes_scanned,
                           blobs_scanned=rep.blobs_scanned,
                           shards_scanned=rep.shards_scanned,
                           findings=len(rep.findings)))

    full = replica.scrub(reset=True)
    note("full", full)
    check(full.complete and full.clean,
          f"the replica scrubs unclean: {full.summary()}")
    flips = inject_bitrot(replica.root, seed=0, count=1,
                          candidates=sorted(_blob_set(replica, fol.image,
                                                      head)))
    victim = flips[0][0]
    where = _first_reference(replica, victim)
    sliced, slices = ScrubReport(), 0
    while True:
        part = replica.scrub(max_bytes=256 << 20)
        note("slice", part)
        sliced.merge(part)
        slices += 1
        if part.complete:
            break
    found = [(f.kind, f.blob, (f.image, f.tag, f.layer_id))
             for f in sliced.findings]
    check(found == [("corrupt_blob", victim, where)],
          f"sliced scrub found {found}; rotted {victim[:12]} at {where}")
    t0 = time.perf_counter()
    rr = repair_image(replica, fol.image, head, peers=[mgr.store],
                      scrub_report=sliced)
    repair_s = time.perf_counter() - t0
    check(rr.verified_clean and rr.repaired_blobs == 1,
          f"repair: {rr}")
    replica.purge_quarantine()
    after = replica.scrub()
    note("full_after_repair", after)
    check(after.complete and after.clean,
          f"the healed replica scrubs unclean: {after.summary()}")
    flat = replica.load_image_payload(fol.image, head)
    tree = {k[len("params/"):]: v for k, v in flat.items()
            if k.startswith("params/")}
    toks = Engine(cfg, unflatten_tree(tree),
                  max_len=prompts.shape[1] + new_tokens + 8,
                  device=dev).generate(prompts, new_tokens)
    check(np.array_equal(toks.tokens, want_tokens),
          "the healed head serves other tokens than a direct engine")
    res = dict(passes=passes, slices=slices, victim=victim[:12],
               attributed=list(where[:2]) + [where[2][:12]],
               repair_seconds=repair_s, repaired_blobs=rr.repaired_blobs,
               bytes_pulled=rr.bytes_pulled, tokens_equal=True,
               launches=fingerprint_leaves.launches)
    log("scrub", **res)
    return res


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _chunk_bytes_changed(flat, old_rows, new_rows, chunk_bytes: int) -> tuple:
    """(chunks whose fingerprint rows differ, their bytes) for a flat tree
    whose leaves are in ``tree_pack_index`` order."""
    from repro_torch.core import tree_pack_index
    index, _, _ = tree_pack_index(flat, chunk_bytes)
    diff = (old_rows != new_rows).any(dim=1).cpu().numpy()
    n = nbytes = 0
    for name, row, n_chunks in index:
        t = flat[name]
        size = t.numel() * t.element_size()
        for j in np.nonzero(diff[row:row + n_chunks])[0]:
            n += 1
            nbytes += min(chunk_bytes, size - int(j) * chunk_bytes)
    return n, nbytes


def profile_step(fn, top: int = 12) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device time of the
    CUDA kernels by name (the ``top`` longest, with their counts), their
    sum, the wall time and the device's busy share of it (kernels do not
    overlap on one stream). The profiler's own cost is in the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA and us > 0:
            kernels.append((us / 1e3, e.count, e.key[:90]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    res = {"wall_ms": wall_ms, "device_ms": busy_ms,
           "busy_share": busy_ms / wall_ms, "kernels": len(kernels),
           "launches": sum(k[1] for k in kernels),
           "top": [{"ms": ms, "count": n, "name": name}
                   for ms, n, name in kernels[:top]]}
    log("train_profile", **res)
    return res


def train_flops(cfg, batch: int, seq: int) -> float:
    """Operations of one train step's useful work: 6 x the matrix
    parameters (all but the embedding table and the norms) x tokens, plus
    attention's 4 D operations per unmasked causal (query, key) pair and
    head, three times (forward, and two products each way in backward)."""
    from repro_torch.models.model import padded_vocab
    d, Vp = cfg.d_model, padded_vocab(cfg)
    per_layer = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * d + 3 * d * cfg.d_ff
    matrix_params = cfg.n_layers * per_layer + d * Vp
    pairs = seq * (seq + 1) / 2
    attn = 3 * 4 * cfg.head_dim * cfg.n_heads * pairs * batch * cfg.n_layers
    return 6.0 * matrix_params * batch * seq + attn


def training_path(cfg, dev, batch: int, seq: int, steps: int,
                  chunk_bytes: int, prompt_len: int, new_tokens: int) -> dict:
    """The training half of the main path, through the entry points a user
    calls: ``make_train_step`` for ``steps`` steps -> a full save of params
    and optimizer state -> ``steps`` more -> an incremental save ->
    ``CheckpointManager.restore`` -> ``Engine.refresh`` of the restored
    params into an engine that served the first save's weights ->
    ``Engine.generate``. Weights from a generator seeded 0, the traffic of
    ``examples/quickstart.py``. Checks every step's loss and grad norm,
    the optimizer's step count, both saves (verified; the second injected,
    its D2H the fingerprint table alone, its writes the changed chunk
    ranges), the restore (bit for bit) and the refreshed engine's tokens
    (those of an engine built on the trained params). The fingerprint
    launches are counted from the first step to the last token."""
    from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
    from repro_torch.core import tree_pack_index
    from repro_torch.core.chunker import dtype_str, shape_of
    from repro_torch.core.fingerprint import chunk_geometry
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.kernels.fingerprint.ref import fingerprint_rows_plain
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.serve import Engine, changed_tensor_paths
    from repro_torch.train import TrainConfig, make_train_step

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = init_opt_state(params)
    _sync(dev)
    n_params = sum(t.numel() for t in _flat(params).values())
    log("train_init", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        params=n_params, param_bytes=_nbytes(params),
        opt_bytes=_nbytes(opt), seconds=time.perf_counter() - t0)
    acfg = AdamWConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=200,
                       weight_decay=0.0)
    bundle = make_train_step(cfg, TrainConfig(adamw=acfg), batch, seq, dev)
    ds = SyntheticTokens(cfg.vocab, batch=batch, seq=seq, seed=0)
    mgr_root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    out = {"step_s": [], "saves": []}

    def train(first: int, n: int) -> None:
        nonlocal params, opt
        for s in range(first, first + n):
            t = time.perf_counter()
            params, opt, met = bundle.fn(params, opt, ds.batch_at(s))
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            out["step_s"].append(time.perf_counter() - t)
            check(np.isfinite(loss) and np.isfinite(gnorm),
                  f"step {s + 1}: loss {loss}, grad norm {gnorm}")
            log("train_step", step=s + 1, loss=loss, grad_norm=gnorm,
                lr=float(met["lr"]), seconds=out["step_s"][-1])

    def plain_rows(flat):
        leaves = [t.to(dev).contiguous() for t in flat.values()]
        geom = [chunk_geometry(shape_of(t), dtype_str(t), chunk_bytes)
                for t in leaves]
        return fingerprint_rows_plain(leaves, geom)

    def save(step: int):
        n0 = fingerprint_leaves.launches
        t = time.perf_counter()
        rep = mgr.save(step, params, opt)
        secs = time.perf_counter() - t
        row = dict(step=step, seconds=secs,
                   fp_launches=fingerprint_leaves.launches - n0,
                   layers_built=rep.layers_built,
                   layers_injected=rep.layers_injected,
                   chunks_written=rep.chunks_written,
                   chunks_prefiltered=rep.chunks_prefiltered,
                   bytes_serialized=rep.bytes_serialized,
                   bytes_hashed=rep.bytes_hashed, bytes_d2h=rep.bytes_d2h)
        out["saves"].append(row)
        log("train_save", **row)
        check(mgr.store.verify_image(mgr.image, mgr.tag_of(step)) == [],
              f"the save of step {step} fails verification")
        return rep

    try:
        mgr = CheckpointManager(mgr_root, cfg.name, CheckpointPolicy(
            incremental=True, use_fingerprints=True, async_write=False,
            chunk_bytes=chunk_bytes))
        # ---- the main path: launches are counted from here to the tokens
        fingerprint_leaves.launches = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        train(0, steps)
        if dev.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        check(int(opt["step"]) == steps, f"optimizer step {int(opt['step'])}")
        union = {}
        for tree in mgr._payloads(params, opt, steps).values():
            union.update(tree)
        _, total_chunks, _ = tree_pack_index(union, chunk_bytes)
        r1 = save(steps)
        check(r1.layers_built == 6, "the first save did not build 6 layers")
        rows1 = plain_rows(union)
        engine = Engine(cfg, _clone(params), max_len=prompt_len + new_tokens
                        + 8, device=dev)

        train(steps, steps)
        check(int(opt["step"]) == 2 * steps,
              f"optimizer step {int(opt['step'])} after {2 * steps} steps")
        union = {}
        for tree in mgr._payloads(params, opt, 2 * steps).values():
            union.update(tree)
        r2 = save(2 * steps)
        changed, changed_bytes = _chunk_bytes_changed(
            union, rows1, plain_rows(union), chunk_bytes)
        check(r2.layers_built == 0 and r2.layers_injected == 4,
              "the incremental save did not inject its 4 content layers")
        check(out["saves"][-1]["fp_launches"] == int(dev.type == "cuda"),
              "the incremental save did not fingerprint in one launch")
        check(r2.bytes_d2h == 8 * total_chunks,
              f"bytes_d2h {r2.bytes_d2h} != 8 x {total_chunks} chunks")
        check(r2.chunks_prefiltered == total_chunks - changed,
              f"prefiltered {r2.chunks_prefiltered}, changed {changed} of "
              f"{total_chunks}")
        check(r2.bytes_serialized == changed_bytes,
              f"serialized {r2.bytes_serialized} B, changed {changed_bytes}")

        t = time.perf_counter()
        rp, ro, rstep = mgr.restore(device=dev)
        _sync(dev)
        restore_s = time.perf_counter() - t
        check(rstep == 2 * steps, f"restored step {rstep}")
        live, got = _flat({"p": params, "o": opt}), _flat({"p": rp, "o": ro})
        check(sorted(got) == sorted(live) and all(
            got[k].dtype == live[k].dtype and torch.equal(got[k], live[k])
            for k in live), "the restore differs from the live state")

        t = time.perf_counter()
        plan = changed_tensor_paths(mgr.store, mgr.image, mgr.tag_of(steps),
                                    mgr.tag_of(2 * steps))
        names = {n[len("params/"):] for n in plan if n.startswith("params/")}
        swapped = engine.refresh(rp, changed=names, step=2 * steps)
        refresh_s = time.perf_counter() - t
        prompts = make_prompts(cfg, 4, prompt_len)
        res = engine.generate(prompts, new_tokens)
        out["launches"] = fingerprint_leaves.launches
        # ---- end of the main path
        res_ref = Engine(cfg, params, max_len=engine.max_len,
                         device=dev).generate(prompts, new_tokens)
        check(np.array_equal(res.tokens, res_ref.tokens),
              "tokens of the refreshed engine differ from a direct engine's")
        if dev.type == "cuda":
            out["profile"] = profile_step(lambda: bundle.fn(
                params, opt, ds.batch_at(2 * steps)))
        log("train_serve", restore_seconds=restore_s,
            refresh_seconds=refresh_s, leaves_swapped=swapped,
            tokens_equal=True, changed_chunks=changed,
            changed_bytes=changed_bytes, total_chunks=total_chunks,
            first_tokens=res.tokens[0, :8].tolist())
        out.update(restore_s=restore_s, refresh_s=refresh_s,
                   total_chunks=total_chunks, n_params=n_params,
                   union=union, changed_chunks=changed)
        del rp, ro, engine
    finally:
        shutil.rmtree(mgr_root, ignore_errors=True)
    return out


REMAT_LOSS_TOL = 0.05     # bf16 loss, tests/test_torch_train.py
REMAT_GRAD_TOL = 1e-4     # x max(1, |g|), tests/test_torch_train.py


def phase_remat_outputs(cfg, dev) -> dict:
    """One ``value_and_grad`` of ``cfg`` on one microbatch of the train
    phase's traffic (2 x 2048 tokens), same weights and batch, under
    remat "none", "outputs" and "nothing" (after one warm-up call): the
    loss and the grad norm of "outputs" within the train step's
    tolerances of "none"'s, and each one's peak device memory above what
    was allocated before it, "outputs" between "nothing" and "none"."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import init_params
    from repro_torch.train.step import value_and_grad
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             SyntheticTokens(cfg.vocab, 2, 2048, seed=0).batch_at(0).items()}
    value_and_grad(cfg.replace(remat="nothing"), params, batch)
    res = {}
    for remat in ("none", "outputs", "nothing"):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, _, grads = value_and_grad(cfg.replace(remat=remat), params,
                                        batch)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                     for g in grads)))
        res[remat] = {"loss": float(loss), "grad_norm": gnorm,
                      "peak_bytes": peak, "seconds": secs}
        del grads
    none, outs = res["none"], res["outputs"]
    err = {"loss": abs(outs["loss"] - none["loss"]),
           "grad_norm": abs(outs["grad_norm"] - none["grad_norm"])
           / max(1.0, none["grad_norm"])}
    check(err["loss"] <= REMAT_LOSS_TOL and err["grad_norm"] <= REMAT_GRAD_TOL,
          f"remat='outputs' against 'none': {err}")
    check(res["nothing"]["peak_bytes"] <= outs["peak_bytes"]
          <= none["peak_bytes"], f"peak memory out of order: {res}")
    res.update(model=cfg.name, layers=cfg.n_layers, batch=2, seq=2048,
               err=err, tol={"loss": REMAT_LOSS_TOL,
                             "grad_norm": REMAT_GRAD_TOL})
    log("remat_outputs", **res)
    return res


def phase_train(dev, layers: int, steps: int) -> dict:
    """Full-width yi-6b with its depth cut to ``layers``, trained through
    ``training_path`` at the quickstart's traffic (batch 4 x 2048 tokens);
    then the fingerprint kernel held bit for bit against its plain version
    on the training tree (params and f32 optimizer state) and timed; then
    ``phase_remat_outputs`` on the same model."""
    from repro_torch.configs import get_config
    cfg = get_config("yi-6b").replace(n_layers=layers)
    batch, seq = 4, 2048
    out = training_path(cfg, dev, batch, seq, steps, chunk_bytes=1 << 20,
                        prompt_len=128, new_tokens=32)
    check(out["launches"] >= 2, "the training path never launched the "
          "fingerprint kernel")
    flops = train_flops(cfg, batch, seq)
    step_s = out["step_s"][1:] or out["step_s"]     # the first compiles
    mean_s = sum(step_s) / len(step_s)
    log("train", layers=layers, batch=batch, seq=seq, steps=2 * steps,
        step_seconds=out["step_s"], mean_step_seconds=mean_s,
        tokens_per_s=batch * seq / mean_s, step_flops=flops,
        flop_bound_seconds=flops / BF16_TENSOR_OPS_PER_S,
        peak_bytes=out.get("peak_bytes"), fp_launches=out["launches"],
        restore_seconds=out["restore_s"], params=out["n_params"])
    out["kernel"] = phase_fingerprint_full(out.pop("union"), 1 << 20,
                                           "fingerprint_train")
    torch.cuda.empty_cache()
    out["remat_outputs"] = phase_remat_outputs(cfg, dev)
    return out


def _leaves_equal(a: dict, b: dict) -> bool:
    """Every leaf of two trees (DTensors by their full tensors) bit-equal,
    one leaf at a time."""
    from repro_torch.sharding.ctx import full_tree
    fa, fb = _flat(a), _flat(b)
    if sorted(fa) != sorted(fb):
        return False
    for k in fa:
        x, y = full_tree(fa[k]), full_tree(fb[k])
        if x.dtype != y.dtype or not torch.equal(x.to(y.device), y):
            return False
    return True


def phase_mesh_1x1(dev, layers: int, steps: int) -> dict:
    """The sharded trainer on a 1x1 NCCL mesh: full-width yi-6b cut to
    ``layers``, recipe ``tp``, ZeRO-1, the train phase's traffic (4 x 2048
    tokens, seed 0), through ``make_train_step(mesh=make_mesh((1, 1)))``.
    Held bit for bit against the one-device step on the same weights and
    batches (loss, grad norm, every updated leaf); then one fingerprinted
    save through the manager (the gathered state, written by rank 0),
    ``reshard_restore`` onto the mesh (bit-equal), the prefill step at 1x1
    against the one-device one (logits bit-equal), ``compressed_psum`` on
    the embedding's gradient against the same call on the CPU, and
    ``launch.train --mesh 1x1 --smoke`` for 4 steps. The fingerprint
    launches are counted from the first mesh step to the restore. Both
    trained states sit on the card at once (2 x 18 GB)."""
    import contextlib
    import io
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
    from repro_torch.ckpt import reshard_restore
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.sharding import spec_tree
    from repro_torch.train import TrainConfig, make_prefill_step, \
        make_train_step
    from repro_torch.train.step import value_and_grad
    cfg = get_config("yi-6b").replace(n_layers=layers)
    batch, seq = 4, 2048
    tcfg = TrainConfig(adamw=AdamWConfig(peak_lr=3e-3, warmup_steps=10,
                                         decay_steps=200, weight_decay=0.0),
                       recipe="tp", zero1=True)
    ds = SyntheticTokens(cfg.vocab, batch=batch, seq=seq, seed=0)
    res = {"layers": layers, "batch": batch, "seq": seq}

    def run(mesh):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        opt = init_opt_state(params)
        bundle = make_train_step(cfg, tcfg, batch, seq, dev, mesh=mesh)
        mets, secs = [], []
        for s in range(steps):
            _sync(dev)
            t = time.perf_counter()
            params, opt, met = bundle.fn(params, opt, ds.batch_at(s))
            _sync(dev)
            secs.append(time.perf_counter() - t)
            mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
        return params, opt, mets, secs, bundle

    t0 = time.perf_counter()
    p1, o1, m1, s1, _ = run(None)
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    res["backend"] = dist.get_backend()
    # ---- the main path: launches are counted from here to the restore
    fingerprint_leaves.launches = 0
    p2, o2, m2, s2, bundle = run(mesh)
    check(m1 == m2, f"loss / grad norm on the 1x1 mesh {m2}, one device {m1}")
    check(_leaves_equal({"p": p2, "o": o2}, {"p": p1, "o": o1}),
          "an updated leaf on the 1x1 mesh differs from one device's")
    del p1, o1
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        mgr = CheckpointManager(root, cfg.name, CheckpointPolicy(
            use_fingerprints=True, async_write=False, chunk_bytes=1 << 20))
        t = time.perf_counter()
        rep = mgr.save(steps, p2, o2)
        res["save_s"] = time.perf_counter() - t
        check(rep.layers_built == 6, "the sharded save did not build 6 layers")
        check(mgr.store.verify_image(mgr.image, mgr.tag_of(steps)) == [],
              "the sharded save fails verification")
        t = time.perf_counter()
        rp, ro, rstep = reshard_restore(mgr, mesh,
                                        spec_tree(bundle.in_shardings[0]),
                                        spec_tree(bundle.in_shardings[1]))
        _sync(dev)
        res["reshard_restore_s"] = time.perf_counter() - t
        res["launches"] = fingerprint_leaves.launches
        # ---- end of the main path
        check(rstep == steps and _leaves_equal({"p": rp, "o": ro},
                                               {"p": p2, "o": o2}),
              "reshard_restore differs from the saved state")
        del rp, ro
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(res["launches"] >= int(dev.type == "cuda"), "the sharded save "
          "never launched the fingerprint kernel")

    prompts = make_prompts(cfg, batch, 128)
    plain = make_prefill_step(cfg, batch, 128, dev).fn(_local_tree(p2),
                                                         prompts)[1]
    meshed = make_prefill_step(cfg, batch, 128, dev, mesh=mesh)
    sharded = meshed.fn(p2, prompts)[1]
    check(_at_out_sharding(sharded, meshed.out_shardings[1]),
          "the 1x1 prefill's logits are not at its out_shardings")
    check(torch.equal(plain, sharded.full_tensor()),
          "the 1x1 prefill's logits differ")

    _, _, grads = value_and_grad(cfg, _local_tree(p2), {
        k: torch.as_tensor(v, device=dev) for k, v in
        SyntheticTokens(cfg.vocab, 2, seq, seed=0).batch_at(0).items()})
    g = grads[len(tree_leaves(p2["blocks"]))].float()     # embed
    check(g.shape == p2["embed"].shape, f"embed grad {tuple(g.shape)}")
    res["compressed_psum_shape"] = list(g.shape)
    del grads
    err = torch.randn(g.shape, generator=torch.Generator(device=dev)
                      .manual_seed(3), device=dev) * 1e-4
    _sync(dev)
    t = time.perf_counter()
    mean, new_err = compressed_psum(g, err, "data", mesh=mesh)
    _sync(dev)
    res["compressed_psum_s"] = time.perf_counter() - t
    cpu_mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu",
                                     mesh_dim_names=("data",))
    cmean, cerr = compressed_psum(g.cpu(), err.cpu(), "data", mesh=cpu_mesh)
    res["compressed_psum_err"] = {
        "mean": float((mean.cpu() - cmean).abs().max()),
        "err": float((new_err.cpu() - cerr).abs().max())}
    check(torch.equal(mean.cpu(), cmean) and torch.equal(new_err.cpu(), cerr),
          f"compressed_psum card vs CPU: {res['compressed_psum_err']}")
    del g, err, mean, new_err, p2, o2
    torch.cuda.empty_cache()

    buf = io.StringIO()
    ck = tempfile.mkdtemp(prefix="chip_smoke_mesh_cli_")
    try:
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_cli.main(["--arch", "yi-6b", "--smoke", "--steps", "4",
                            "--batch", "2", "--seq", "64", "--mesh", "1x1",
                            "--device", dev.type, "--ckpt", ck,
                            "--ckpt-every", "2"])
        res["launcher_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    text = buf.getvalue()
    check("[train] 4 steps in" in text and "mesh 1x1" in text,
          f"the launcher did not train on the mesh:\n{text}")
    res.update(one_device=m1, mesh=m2, one_device_step_s=s1, mesh_step_s=s2,
               bit_equal=True, launcher=text.strip().splitlines()[-1],
               seconds=time.perf_counter() - t0)
    log("mesh_1x1", **res)
    return res


MESH_ARCH_RECIPES = (None, "sp", "dp")   # None: recipe_for's choice


def _at_out_sharding(x, sharding) -> bool:
    """``x`` is a DTensor at ``sharding``'s placements (a meshed step's
    logits: sharded as the reference leaves them, never gathered)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding import placements
    return isinstance(x, DTensor) and tuple(x.placements) == tuple(
        placements(sharding.mesh, sharding.spec, x.ndim))


def phase_mesh_archs(dev) -> dict:
    """Every arch's f32 smoke model on the 1x1 NCCL mesh against one
    device, for each recipe of ``MESH_ARCH_RECIPES`` (``sp`` routes the moe
    archs through ``_moe_local``): one train step (loss, grad norm and
    every updated leaf bit-equal), then the meshed prefill (4 x 24) and
    two decode steps (logits bit-equal). A 1x1 mesh keeps DTensor's
    sharding propagation (size-1 dims stay ``Shard``), so this is where
    the card's torch takes or refuses each family's meshed operations."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.train import TrainConfig, make_decode_step, \
        make_prefill_step, make_train_step
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    t0 = time.perf_counter()
    recipes = {}
    B, S = 4, 24
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                             compute_dtype="float32")
        batch = SyntheticTokens(cfg.vocab, B, S, seed=4).batch_at(0)
        toks = batch["tokens"]
        for name in MESH_ARCH_RECIPES:
            runs = []
            for m in (None, mesh):
                p = init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(4), dev)
                b = make_train_step(cfg, TrainConfig(recipe=name), B, S, dev,
                                    mesh=m)
                p, o, met = b.fn(p, init_opt_state(p), batch)
                pre = make_prefill_step(cfg, B, S, dev, mesh=m,
                                        recipe_name=name)
                _, logits = pre.fn(p, toks)
                dec = make_decode_step(cfg, B, S, dev, mesh=m)
                cache = init_cache(cfg, B, S, dev)
                steps = []
                for pos in range(2):
                    cache, lg = dec.fn(p, cache, toks[:, pos], pos)
                    steps.append(lg)
                if m is not None:   # sharded logits, gathered here
                    check(_at_out_sharding(logits, pre.out_shardings[1])
                          and all(_at_out_sharding(lg, dec.out_shardings[1])
                                  for lg in steps),
                          f"{arch}, recipe {name}: meshed logits are not "
                          "at the steps' out_shardings")
                    logits = logits.full_tensor()
                    steps = [lg.full_tensor() for lg in steps]
                runs.append(({"p": p, "o": o}, met, logits, steps,
                             b.recipe.name if b.recipe else None))
            (t1, m1, l1, d1, _), (t2, m2, l2, d2, rname) = runs
            check(all(float(m1[k]) == float(m2[k])
                      for k in ("loss", "grad_norm")) and
                  _leaves_equal(t2, t1),
                  f"{arch}, recipe {rname}: the 1x1 step differs")
            check(torch.equal(l1, l2) and all(
                torch.equal(a, c) for a, c in zip(d1, d2)),
                f"{arch}, recipe {rname}: 1x1 prefill/decode logits differ")
            recipes.setdefault(arch, []).append(rname)
    res = {"recipes": recipes, "seconds": time.perf_counter() - t0,
           "bit_equal": True}
    log("mesh_archs", **res)
    return res


SPLIT_DECODE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
QUERY_BLOCKS_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def phase_split_attention(dev) -> dict:
    """What each rank of a meshed step computes, on the card at production
    width (two ranks cannot share the card): the split-cache decode of one
    yi-6b layer's full cache (B 8, C 32,768, KVH 4, Hq 32, D 128), cut into
    16 blocks along its length as a 16-wide "model" axis cuts it, each
    block's ``decode_partials`` at its global slot positions, merged by
    ``combine_partials``; and the query-offset attention at yi-6b's width
    (S 4096, 16 query blocks, causal), each block through
    ``attention_blockwise`` at its global offset. Each against the unsplit
    function on the same card tensors, bf16 and f32, and timed beside it
    (the 16 blocks run one after another here)."""
    from repro_torch.models.attention import (attention, attention_blockwise,
                                              attention_decode,
                                              combine_partials,
                                              decode_partials, finish_decode)
    from repro_torch.models.blocks import _cache_positions
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(24)
    B, C, KVH, Hq, D, parts = 8, 32768, 4, 32, 128, 16
    pos = C + C // 3                     # a ring that has wrapped
    cpos = _cache_positions(C, pos, dev)
    step = C // parts
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((B, 1, Hq, D), generator=g, device=dev).to(dt)
        k = torch.randn((B, C, KVH, D), generator=g, device=dev).to(dt)
        v = torch.randn((B, C, KVH, D), generator=g, device=dev).to(dt)

        def split():
            blocks = [decode_partials(q, k[:, a:a + step], v[:, a:a + step],
                                      cpos[a:a + step], pos)
                      for a in range(0, C, step)]
            m, l, acc = (torch.stack(t) for t in zip(*blocks))
            return finish_decode(combine_partials(m, l, acc), q.dtype)

        def whole():
            return attention_decode(q, k, v, cpos, pos)

        err = _max_err(split(), whole())
        check(err <= SPLIT_DECODE_TOL[dt],
              f"split decode {dt}: {err} > {SPLIT_DECODE_TOL[dt]}")
        name = str(dt).split(".")[-1]
        out[f"decode_{name}"] = {"max_abs_err": err,
                                 "split_ms": cuda_ms(split, 5),
                                 "whole_ms": cuda_ms(whole, 5)}
        del q, k, v
        torch.cuda.empty_cache()
    S, Bq = 4096, 1
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((Bq, S, Hq, D), generator=g, device=dev).to(dt)
        k = torch.randn((Bq, S, Hq, D), generator=g, device=dev).to(dt)
        v = torch.randn((Bq, S, Hq, D), generator=g, device=dev).to(dt)
        rows = S // parts

        def blocks():
            return torch.cat([attention_blockwise(q[:, a:a + rows], k, v,
                                                  _q_offset=a)
                              for a in range(0, S, rows)], dim=1)

        def whole():
            return attention(q, k, v)

        err = _max_err(blocks(), whole())
        check(err <= QUERY_BLOCKS_TOL[dt],
              f"query blocks {dt}: {err} > {QUERY_BLOCKS_TOL[dt]}")
        name = str(dt).split(".")[-1]
        out[f"query_{name}"] = {"max_abs_err": err,
                                "split_ms": cuda_ms(blocks, 3),
                                "whole_ms": cuda_ms(whole, 3)}
        del q, k, v
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("split_attention", **out)
    return out


DLC_LAYERS = 2     # yi-6b at full width cut to 2 layers: 1.74 GB of bf16
DLC_CHUNK = 1 << 20


def phase_dlc_baseline(dev) -> dict:
    """The paper's baseline beside the fingerprint prefilter (DLC rule 3,
    the COPY cache check), on two stores: ``LayerStore(
    record_fingerprints=False)``, the seed's Docker-faithful rule (a COPY
    cache check re-chunks and re-hashes the whole payload), and the
    default (the check is one fingerprint launch against the records'
    sidecars). Each builds ``FROM yi-6b; COPY params; CMD serve`` from
    yi-6b's full-width weights (depth cut to ``DLC_LAYERS``), rebuilds it
    with the payload unchanged, then saves incrementally after one leaf
    changes (the fingerprint diff against the tables a manager keeps, then
    ``inject_image_multi``)."""
    from repro_torch.configs import get_config
    from repro_torch.core import (Instruction, LayerStore, diff_image,
                                  fingerprint_tree_packed, inject_image_multi)
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.models import init_params
    cfg = get_config("yi-6b").replace(n_layers=DLC_LAYERS)
    t_phase = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    edited, _ = _edit_leaf(params, "blocks/wk", 1)
    flat, flat2 = _flat(params), _flat(edited)
    payload_bytes = sum(t.numel() * t.element_size() for t in flat.values())
    ins = [Instruction("FROM", cfg.name, "config"),
           Instruction("COPY", "params", "content"),
           Instruction("CMD", "serve", "config")]
    res, layers = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dlc_")
    try:
        for name, flag in (("docker", False), ("fingerprints", True)):
            store = LayerStore(os.path.join(tmp, name), chunk_bytes=DLC_CHUNK,
                               record_fingerprints=flag)
            out = {}
            for tag, parent in (("v1", None), ("v2", ("app", "v1"))):
                _sync(dev)
                fingerprint_leaves.launches = 0
                t0 = time.perf_counter()
                _, _, rep = store.build_image(
                    "app", tag, ins, {"params": lambda: flat}, parent=parent,
                    arch=cfg.name)
                _sync(dev)
                out[tag] = {"seconds": time.perf_counter() - t0,
                            "fp_launches": fingerprint_leaves.launches,
                            **{k: getattr(rep, k) for k in (
                                "layers_built", "layers_cached",
                                "bytes_hashed", "chunks_prefiltered",
                                "chunks_written")}}
            # the tables a manager with use_fingerprints keeps (_last_fps)
            old_fps = fingerprint_tree_packed(flat, DLC_CHUNK)
            fingerprint_leaves.launches = 0
            t0 = time.perf_counter()
            new_fps = fingerprint_tree_packed(flat2, DLC_CHUNK)
            manifest, _ = store.read_image("app", "v2")
            diffs = diff_image([store.read_layer(lid)
                                for lid in manifest.layer_ids],
                               {"params": flat2}, old_fps, new_fps)
            _, _, rep = inject_image_multi(store, "app", "v2", "v3", diffs,
                                           {"params": lambda: flat2})
            out["v3"] = {"seconds": time.perf_counter() - t0,
                         "fp_launches": fingerprint_leaves.launches,
                         "chunks_written": rep.chunks_written,
                         "bytes_hashed": rep.bytes_hashed,
                         "layers_injected": rep.layers_injected}
            layers[name] = {tag: [store.read_layer(lid, use_cache=False)
                                  for lid in store.read_image(
                                      "app", tag)[0].layer_ids]
                            for tag in ("v1", "v2", "v3")}
            res[name] = out
            log("dlc_baseline", store=name, record_fingerprints=flag,
                payload_bytes=payload_bytes, **out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    off, on = res["docker"], res["fingerprints"]
    total_chunks = sum(len(r.chunks) for r in layers["docker"]["v1"][1].records)
    check(off["v2"]["layers_cached"] == on["v2"]["layers_cached"] == 3,
          "the unchanged rebuild missed the cache")
    check(off["v2"]["bytes_hashed"] == payload_bytes and
          off["v2"]["fp_launches"] == 0 and
          off["v2"]["chunks_prefiltered"] == 0,
          "the Docker-faithful cache hit did not hash the whole layer alone")
    check(on["v2"]["bytes_hashed"] == 0 and on["v2"]["fp_launches"] == 1 and
          on["v2"]["chunks_prefiltered"] == total_chunks,
          "the fingerprinted cache hit hashed bytes or missed its launch")
    check(off["v1"]["fp_launches"] == 0 and on["v1"]["fp_launches"] == 1,
          "the builds' fingerprint launches are not 0 and 1")
    for tag in ("v1", "v2", "v3"):
        check([(la.checksum, la.chain) for la in layers["docker"][tag]] ==
              [(la.checksum, la.chain) for la in layers["fingerprints"][tag]],
              f"{tag}: the two stores' checksums differ")
    check(all(r.fp is None for tag in ("v1", "v2", "v3")
              for la in layers["docker"][tag] for r in la.records),
          "a record of the Docker-faithful store carries a sidecar")
    v2_chunks = {h for r in layers["docker"]["v2"][1].records
                 for h in r.chunks}
    changed = {h for r in layers["docker"]["v3"][1].records
               for h in r.chunks} - v2_chunks
    written = {name: {h for r in layers[name]["v3"][1].records
                      for h in r.chunks} - v2_chunks for name in layers}
    check(written["fingerprints"] == written["docker"] == changed and
          off["v3"]["chunks_written"] == on["v3"]["chunks_written"] ==
          len(changed) > 0 and
          off["v3"]["fp_launches"] == on["v3"]["fp_launches"] == 1,
          "the incremental saves wrote different chunks")
    out = {"payload_bytes": payload_bytes, "chunks": total_chunks,
           "changed_chunks": len(changed), "docker": off, "fingerprints": on,
           "seconds": time.perf_counter() - t_phase}
    log("dlc_baseline_done", payload_bytes=payload_bytes, chunks=total_chunks,
        changed_chunks=len(changed), seconds=out["seconds"],
        card=subprocess.run(CARD_SHELL, capture_output=True, text=True,
                            timeout=60).stdout.strip()
        if dev.type == "cuda" else None)
    return out


CRASH_CHILD_TIMEOUT_S = 300
_CRASH_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; chip_smoke.crash_save_child(*sys.argv[2:])")


def _crash_policy():
    from repro_torch.ckpt import CheckpointPolicy
    return CheckpointPolicy(use_fingerprints=True, chunk_bytes=DLC_CHUNK,
                            async_write=False, keep=10)


def _crash_model(device: str):
    """The weights both sides of ``crash_save`` hold: ``dlc_baseline``'s
    model (on a CPU, where the phase is tried at a small size, yi-6b's
    smoke config), drawn from seed 0 on ``device``, and a copy with layer
    1 of blocks/wk edited."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import init_params
    dev = torch.device(device)
    cfg = get_smoke_config("yi-6b") if dev.type == "cpu" else \
        get_config("yi-6b").replace(n_layers=DLC_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return cfg, params, _edit_leaf(params, "blocks/wk", 1)[0]


def crash_save_child(root: str, tables: str, device: str) -> None:
    """The trainer that dies (``phase_crash_save`` runs it in a process of
    its own): a full save of step 1, the fingerprint tables of step 1 and
    of the edited weights into ``tables``, then the incremental save of
    step 2, killed by SIGKILL inside ``LayerStore.write_blob`` once its
    first new blob has landed."""
    import signal
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import LayerStore, fingerprint_tree
    t0 = time.perf_counter()
    cfg, params, edited = _crash_model(device)
    mgr = CheckpointManager(root, cfg.name, _crash_policy())
    mgr.save(1, params, {})
    np.savez(tables, **{f"{step}:{k}": v for step, tree in (
        ("step1", params), ("step2", edited)) for k, v in fingerprint_tree(
            _flat(tree, "params"), DLC_CHUNK).items()})
    write_blob = LayerStore.write_blob

    def dying_write_blob(self, h, data):
        new = write_blob(self, h, data)
        if new:
            print(json.dumps({"killed_in": "LayerStore.write_blob",
                              "blob": h, "seconds":
                              time.perf_counter() - t0}), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        return new

    LayerStore.write_blob = dying_write_blob
    print("READY", flush=True)
    mgr.save(2, edited, {})
    print("UNREACHABLE", flush=True)


def phase_crash_save(dev) -> dict:
    """A trainer killed mid-save and restarted. A child process draws
    ``dlc_baseline``'s weights on the card, saves step 1 in full, and dies
    by SIGKILL inside the incremental save of step 2, after its first new
    blob. The store must then show step 1 alone, deep-verified, and
    restore it onto the card bit for bit (by fingerprint table). A fresh
    manager (the restart: no fingerprint baseline) saves the edited
    weights this process drew from the same seed as step 2: it must
    inject, hash on the host every byte of the tree (the fall-back of
    ``core/diff.py`` for a leaf with no old table), write no chunk outside
    the changed ones, and restore bit for bit."""
    import signal

    import repro_torch.core.diff as diff_mod
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import LayerStore, fingerprint_tree
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_crash_")
    try:
        root = os.path.join(tmp, "ckpt")
        tables = os.path.join(tmp, "tables.npz")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _CRASH_CHILD, ROOT, root, tables,
             str(dev)],
            capture_output=True, text=True, timeout=CRASH_CHILD_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        check(proc.returncode == -signal.SIGKILL and
              "READY" in proc.stdout and "UNREACHABLE" not in proc.stdout,
              f"the saving child did not die by SIGKILL: rc "
              f"{proc.returncode}, {proc.stderr[-2000:]}")
        killed = json.loads(proc.stdout.strip().splitlines()[-1])
        fps = np.load(tables)
        want = {s: {k.split(":", 1)[1]: fps[k] for k in fps.files
                    if k.startswith(s + ":")} for s in ("step1", "step2")}

        store = LayerStore(root, chunk_bytes=DLC_CHUNK)
        mgr = CheckpointManager(root, "yi-6b", _crash_policy(), store=store)
        tag1, tag2 = mgr.tag_of(1), mgr.tag_of(2)
        check(mgr.latest_step() == 1 and store.list_tags("ckpt") == [tag1],
              f"after the kill the store shows {store.list_tags('ckpt')}")
        check(store.verify_image("ckpt", tag1, deep=True) == [],
              "step 1 does not deep-verify after the kill")
        step1_blobs = _blob_set(store, "ckpt", tag1)
        leftovers = set(_store_blobs(store)) - step1_blobs
        check(killed["blob"] in leftovers,
              "the blob the child landed before dying is not on disk")

        def restore(step):
            _sync(dev)
            t = time.perf_counter()
            got = CheckpointManager(root, "yi-6b", _crash_policy()).restore(
                step, device=dev)
            _sync(dev)
            return got, time.perf_counter() - t

        def same_tables(params, step) -> bool:
            got = fingerprint_tree(_flat(params, "params"), DLC_CHUNK)
            return got.keys() == want[step].keys() and all(
                np.array_equal(got[k], want[step][k]) for k in got)

        (params1, _, step), restore1_s = restore(1)
        check(step == 1 and same_tables(params1, "step1"),
              "step 1 restored onto the card differs from the child's")
        del params1

        _, _, edited = _crash_model(str(dev))
        payload_bytes = _nbytes(edited) + 4         # + opt/__step__ (int32)
        hashed = [0]
        hash_chunks = diff_mod.hash_chunks

        def counting_hash_chunks(pieces):
            pieces = list(pieces)
            hashed[0] += sum(len(p) for p in pieces)
            return hash_chunks(pieces)

        diff_mod.hash_chunks = counting_hash_chunks
        try:
            restarted = CheckpointManager(root, "yi-6b", _crash_policy())
            _sync(dev)
            t0 = time.perf_counter()
            rep = restarted.save(2, edited, {})
            save_s = time.perf_counter() - t0
        finally:
            diff_mod.hash_chunks = hash_chunks
        changed = _blob_set(store, "ckpt", tag2) - step1_blobs
        landed = changed & leftovers
        check(rep.layers_built == 0 and rep.layers_injected == 2,
              f"the restarted save rebuilt: {rep}")
        check(hashed[0] == payload_bytes and rep.chunks_prefiltered == 0,
              f"the restarted save hashed {hashed[0]} B on the host, not "
              f"the tree's {payload_bytes}")
        check(landed and rep.chunks_written + len(landed) == len(changed),
              f"the restarted save wrote {rep.chunks_written} chunks, the "
              f"child landed {len(landed)} of the {len(changed)} changed")
        del edited
        (params2, _, step), restore2_s = restore(2)
        check(step == 2 and same_tables(params2, "step2"),
              "step 2 restored onto the card differs from the child's table")
        del params2
        check(store.verify_image("ckpt", tag2, deep=True) == [],
              "step 2 does not deep-verify")
        out = {"child_seconds": child_s, "child_seconds_to_kill":
               killed["seconds"], "kill_point": killed["killed_in"],
               "blobs_uncommitted": len(leftovers),
               "restore1_seconds": restore1_s,
               "restore2_seconds": restore2_s,
               "restart_save_seconds": save_s,
               "restart_bytes_hashed_host": hashed[0],
               "restart_bytes_hashed_report": rep.bytes_hashed,
               "payload_bytes": payload_bytes,
               "chunks_written": rep.chunks_written,
               "changed_chunks": len(changed), "fsyncs": rep.fsyncs,
               "seconds": time.perf_counter() - t_phase}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("crash_save", **out,
        card=subprocess.run(CARD_SHELL, capture_output=True, text=True,
                            timeout=60).stdout.strip()
        if dev.type == "cuda" else None)
    return out


def _local_tree(tree):
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    return tree.to_local() if hasattr(tree, "to_local") else tree


def run_model(arch: str, dev, edit: str, edit_layer: int, batch: int,
              prompt_len: int, new_tokens: int, follower: str, extras=(),
              layers=None) -> dict:
    """One model at full width (depth cut to ``layers`` when given), weights
    drawn on the card from a seeded generator, through ``serving_path``;
    checks the fingerprint launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log("init", arch=arch, seconds=time.perf_counter() - t0,
        param_bytes=_nbytes(params), layers=cfg.n_layers,
        d_model=cfg.d_model, dtype=cfg.param_dtype)
    out = serving_path(cfg, params, dev, chunk_bytes=1 << 20, batch=batch,
                       prompt_len=prompt_len, new_tokens=new_tokens,
                       edit=edit, edit_layer=edit_layer, follower=follower,
                       extras=extras)
    check(out["save2_launches"] == 1,
          f"incremental save made {out['save2_launches']} kernel launches")
    check(out["launches"] >= 1, "the main path never launched the kernel")
    out["cfg"] = cfg
    return out


ROOFLINE_SERVE_BATCH, ROOFLINE_PROMPT, ROOFLINE_CACHE = 4, 128, 168


def _roofline_held(kind: str, fn, args, model_flops: float, reps: int,
                   dev) -> dict:
    """``fn(*args)`` counted by ``roofline.analyze_step`` on the real
    tensors and again traced under ``FakeTensorMode`` (the dry-run's way)
    from fakes of the same tensors: the FLOP counts must be equal; each
    operation whose bytes differ is logged. The step is then timed with the
    counter off (its Python adds host time to every operation)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline import HW, analyze_step
    common = dict(arch="yi-6b", shape=kind, mesh_name="one", recipe="",
                  model_flops=model_flops, n_devices=1)
    real = analyze_step(fn, args, **common)
    _sync(dev)
    fake_mode = FakeTensorMode()

    def fake(t):
        if isinstance(t, dict):
            return {k: fake(v) for k, v in t.items()}
        return fake_mode.from_tensor(t) if isinstance(t, torch.Tensor) else t
    fake_args = [fake(a) for a in args]
    with fake_mode:
        traced = analyze_step(fn, fake_args, **common)
    check(real.flops_per_device > 0 and real.bytes_per_device > 0,
          f"{kind}: nothing counted on the card")
    check(real.flops_per_device == traced.flops_per_device,
          f"{kind}: {real.flops_per_device} FLOPs counted on the card, "
          f"{traced.flops_per_device} traced on fake tensors")
    byte_diffs = {op: [real.by_op.get(op, [0, 0, 0])[2],
                       traced.by_op.get(op, [0, 0, 0])[2]]
                  for op in sorted(set(real.by_op) | set(traced.by_op))
                  if real.by_op.get(op, [0, 0, 0])[2]
                  != traced.by_op.get(op, [0, 0, 0])[2]}
    step_ms = _host_ms(lambda: fn(*args), reps, dev)
    terms = real.terms(HW())
    bound_s = max(terms["compute_s"], terms["memory_s"],
                  terms["collective_s"])
    res = {"flops": real.flops_per_device,
           "flops_traced": traced.flops_per_device,
           "bytes": real.bytes_per_device,
           "bytes_traced": traced.bytes_per_device,
           "byte_diffs_by_op": byte_diffs,
           "operations": sum(v[0] for v in real.by_op.values()),
           "model_flops": model_flops, "terms": terms,
           "bound_ms": bound_s * 1e3, "step_ms": step_ms,
           "step_over_bound": step_ms / (bound_s * 1e3),
           "temp_bytes_traced": traced.temp_bytes,
           "count_seconds": real.compile_seconds,
           "trace_seconds": traced.compile_seconds}
    log(f"roofline_{kind}", **res)
    return res


def phase_roofline(dev) -> dict:
    """The roofline counter held against what runs on the card: the train
    phase's model (yi-6b, full width, ``TRAIN_LAYERS`` layers, 4 x 2048
    tokens) for one train step, and the serving phase's (``YI_SERVE_LAYERS``
    layers, 4 prompts of 128 tokens) for its prefill and one decode step.
    Each is counted on the real tensors and traced on fake ones
    (``_roofline_held``); the train step's count is printed beside
    ``train_flops``'s hand count."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import init_cache, init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.train import (TrainConfig, make_decode_step,
                                   make_prefill_step, make_train_step)
    t0 = time.perf_counter()
    out = {}
    cfg = get_config("yi-6b").replace(n_layers=TRAIN_LAYERS)
    batch, seq = 4, 2048
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = init_opt_state(params)
    host = SyntheticTokens(cfg.vocab, batch=batch, seq=seq, seed=0).batch_at(0)
    data = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    step = make_train_step(cfg, TrainConfig(), batch, seq, dev).fn
    n = cfg.active_param_count()
    out["train"] = _roofline_held("train", step, [params, opt, data],
                                  6.0 * n * batch * seq, 2, dev)
    hand = train_flops(cfg, batch, seq)
    out["train"].update(hand_flops=hand,
                        hand_over_counted=hand / out["train"]["flops"])
    log("roofline_train_hand", layers=TRAIN_LAYERS, hand_flops=hand,
        counted_flops=out["train"]["flops"],
        hand_over_counted=out["train"]["hand_over_counted"])
    del params, opt, step
    torch.cuda.empty_cache()

    cfg = get_config("yi-6b").replace(n_layers=YI_SERVE_LAYERS)
    B, S = ROOFLINE_SERVE_BATCH, ROOFLINE_PROMPT
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n = cfg.active_param_count()
    toks = torch.as_tensor(make_prompts(cfg, B, S), device=dev)
    prefill = make_prefill_step(cfg, B, S, dev).fn
    out["prefill"] = _roofline_held("prefill", prefill, [params, toks],
                                    2.0 * n * B * S, 3, dev)
    cache = init_cache(cfg, B, ROOFLINE_CACHE, dev)
    decode = make_decode_step(cfg, B, ROOFLINE_CACHE, dev).fn
    out["decode"] = _roofline_held("decode", decode,
                                   [params, cache, toks[:, -1], S],
                                   2.0 * n * B, 5, dev)
    del params, cache
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("roofline", seconds=out["seconds"])
    return out


# the dry-run cells chip_smoke traces at production size: the dense train
# and decode steps on the pod, the sharded MoE prefill on two pods (512
# ranks), the SSM scan on local batch rows at 500k tokens, and attention
# under sequence parallelism (gemma-2b, recipe "sp")
DRYRUN_CELLS = (("yi-6b", "train_4k", "pod"), ("yi-6b", "decode_32k", "pod"),
                ("mixtral-8x7b", "prefill_32k", "multipod"),
                ("hymba-1.5b", "long_500k", "pod"),
                ("gemma-2b", "prefill_32k", "pod"))
# what the split meshed paths must keep each of these cells under (the
# parent tree's figures in PERF.md: the decode all-gathered 17.2 GB of
# cache a step, the MoE ran replicated at a useful share of 0.00178, and
# sp attention's memory term was 6.92 s)
DRYRUN_LIMITS = {
    ("yi-6b", "decode_32k", "pod"):
        ("collective bytes a step", lambda d: d["coll_bytes"]["total"],
         "<", 100e6),
    ("mixtral-8x7b", "prefill_32k", "multipod"):
        ("useful FLOP share", lambda d: d["terms"]["useful_flops_ratio"],
         ">=", 10 * 0.00178),
    ("gemma-2b", "prefill_32k", "pod"):
        ("memory term, s", lambda d: d["terms"]["memory_s"], "<", 6.92),
}
DRYRUN_TAG = "chip_smoke"
DRYRUN_TIMEOUT_S = 900


class DryRun:
    """The dry-run cells, one ``python -m repro_torch.launch.dryrun``
    subprocess each, run one after another on a thread from the start of
    the script: they trace fake tensors on the host while the other phases
    use the card. ``finish`` waits for them and reads each cell's result;
    ``stop`` kills a cell still running."""

    def __init__(self):
        import threading
        self.results, self.proc, self.stopped = {}, None, False
        self.lock = threading.Lock()
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        from repro_torch.launch.dryrun import result_path
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        for arch, shape, mesh in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--device", "cuda", "--tag", DRYRUN_TAG]
            t = time.perf_counter()
            with self.lock:
                if self.stopped:
                    return
                self.proc = subprocess.Popen(
                    cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
            try:
                tail = self.proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                self.proc.kill()
                tail = self.proc.communicate()[0] + "\n(timed out)"
            path = result_path(arch, shape, mesh, DRYRUN_TAG)
            rec = {"rc": self.proc.returncode, "tail": tail[-2000:],
                   "wall_s": time.perf_counter() - t}
            if os.path.exists(path):
                with open(path) as f:
                    rec["result"] = json.load(f)
            self.results[(arch, shape, mesh)] = rec

    def stop(self) -> None:
        with self.lock:
            self.stopped = True
            if self.proc is not None and self.proc.poll() is None:
                self.proc.kill()
        self.thread.join(timeout=60)

    def finish(self) -> dict:
        t = time.perf_counter()
        self.thread.join(timeout=DRYRUN_TIMEOUT_S * len(DRYRUN_CELLS))
        check(not self.thread.is_alive(), "the dry-run cells did not end")
        waited = time.perf_counter() - t
        for cell in DRYRUN_CELLS:
            rec = self.results.get(cell)
            check(rec is not None, f"dry-run cell {cell} did not run")
            d = rec.get("result", {})
            check(rec["rc"] == 0 and d.get("ok"),
                  f"dry-run cell {cell} failed (exit {rec['rc']}): "
                  f"{d.get('error')}\n{rec['tail']}")
            check(d["flops_per_device"] > 0 and d["bytes_per_device"] > 0
                  and all(np.isfinite(v) for v in d["terms"].values()
                          if not isinstance(v, str)),
                  f"dry-run cell {cell}: empty or non-finite terms")
            if cell in DRYRUN_LIMITS:
                what, read, op, limit = DRYRUN_LIMITS[cell]
                got = read(d)
                check(got < limit if op == "<" else got >= limit,
                      f"dry-run cell {cell}: {what} {got} not {op} {limit}")
            log("dryrun_cell", arch=cell[0], shape=cell[1], mesh=cell[2],
                recipe=d["recipe"], terms=d["terms"],
                flops_per_device=d["flops_per_device"],
                bytes_per_device=d["bytes_per_device"],
                coll_bytes=d["coll_bytes"], temp_bytes=d["temp_bytes"],
                trace_seconds=d["compile_seconds"], wall_s=rec["wall_s"],
                device=d["device"], torch=d["torch"])
        res = {"cells": len(DRYRUN_CELLS), "waited_s": waited,
               "since_start_s": time.perf_counter() - self.t0}
        log("dryrun", **res)
        return res


def _row(name, source, replaces, launches, res, others=()) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           **{k: res[k] for k in keys}}
    extra = ("shape", "model", "dtype", "library", "graph_ms", "phase_ms")
    row.update({k: res[k] for k in extra if k in res})
    if others:
        row["other_shapes"] = [{k: o[k] for k in keys + extra + (
            "bytes_bound_ms", "ops_bound_ms", "alu_bound_ms") if k in o}
            for o in others]
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dry = DryRun()
    try:
        return _main(dev, dry, t_start)
    finally:
        dry.stop()


def _main(dev, dry: DryRun, t_start: float) -> int:
    phase_build()
    phase_kernel_edges(dev)
    phase_flash_edges(dev)
    phase_ssd_edges(dev)
    phase_reference_check(dev)
    phase_moe_dispatch(dev)
    phase_watchdog()
    phase_examples()

    # slice 1: the dense family at full width, depth cut
    yi = run_model("yi-6b", dev, edit="blocks/wk", edit_layer=3, batch=4,
                   prompt_len=128, new_tokens=32, follower="smart",
                   extras=("fp_per_leaf", "fp_tree", "specs", "repair",
                           "steps", "sample"), layers=YI_SERVE_LAYERS)
    fp_dense, fp_dense_launches = yi["kernel"], yi["launches"]
    store_paths = {"fp_per_leaf": yi["fp_per_leaf"]["launches"]}
    per_leaf, fp_tree = yi["fp_per_leaf"], yi["fp_tree"]
    del yi
    torch.cuda.empty_cache()

    # slice 8: the moe family (depth cut) with the tenants forked from its
    # base, and the mla family at full depth
    mx = run_model("mixtral-8x7b", dev, edit="blocks/router", edit_layer=1,
                   batch=4, prompt_len=128, new_tokens=32, follower="smart",
                   extras=("tenants",), layers=MIXTRAL_LAYERS)
    fp, fp_launches = mx["kernel"], mx["launches"]
    store_paths.update(tenants=mx["tenants"]["launches"],
                       replicate=mx["replicate"]["launches"])
    del mx
    torch.cuda.empty_cache()
    mc = run_model("minicpm3-4b", dev, edit="blocks/wkv_b", edit_layer=3,
                   batch=4, prompt_len=128, new_tokens=32, follower="smart")
    fp_mla_launches = mc["launches"]
    del mc
    torch.cuda.empty_cache()

    # slice 2: the hybrid family at full width; then the two kernels' own
    # entry points on the tensors its prefill computes
    hy = run_model("hymba-1.5b", dev, edit="blocks/ssm/w_x", edit_layer=3,
                   batch=2, prompt_len=4096, new_tokens=32,
                   follower="passive", extras=("scrub",))
    cfg = hy["cfg"]
    path = phase_kernel_path(cfg, hy["engine"].params, hy["prompts"], dev)
    full = phase_kernel_full(path["layer0"], cfg)
    fp_hybrid_launches, launches = hy["launches"], path["launches"]
    store_paths["scrub"] = hy["scrub"]["launches"]
    ssd_cuda_kernels = path["ssd_cuda_kernels"]
    del hy, path
    torch.cuda.empty_cache()
    seeded = phase_seeded_shapes(dev)
    torch.cuda.empty_cache()

    # slice 5: the training half at yi-6b's full width, depth cut to fit
    tr = phase_train(dev, layers=TRAIN_LAYERS, steps=TRAIN_STEPS)
    torch.cuda.empty_cache()

    # slice 11: the roofline counter against the card, then the dry-run
    # cells that have been tracing on the host since the start
    phase_roofline(dev)

    # slice 10: the sharded trainer on a 1x1 NCCL mesh (several ranks on
    # one card would need gloo, whose all-gather of CUDA tensors crashes:
    # PERF.md §7)
    mesh = phase_mesh_1x1(dev, layers=TRAIN_LAYERS, steps=TRAIN_STEPS)
    phase_mesh_archs(dev)
    # slice 12: what each rank of the split meshed paths computes
    phase_split_attention(dev)
    # slice 13: the seed's Docker-faithful COPY cache check beside the
    # fingerprint prefilter
    phase_dlc_baseline(dev)
    torch.cuda.empty_cache()
    # slice 16: a trainer killed by SIGKILL mid-save, then restarted
    phase_crash_save(dev)
    torch.cuda.empty_cache()
    dry.finish()

    fp_row = _row("fingerprint",
                  "src/repro_torch/kernels/fingerprint/csrc/fingerprint.cu",
                  "src/repro/kernels/fingerprint/kernel.py:44",
                  fp_launches, dict(fp, shape=[fp["rows"]],
                                       model="mixtral-8x7b",
                                       library_ms=None))
    fp_row.update(check="bit-exact", tree_bytes=fp["tree_bytes"],
                  launches_dense_path=fp_dense_launches,
                  launches_hybrid_path=fp_hybrid_launches,
                  launches_mla_path=fp_mla_launches,
                  launches_train_path=tr["launches"],
                  launches_mesh_path=mesh["launches"],
                  launches_store_paths=store_paths,
                  launches_fingerprint_tree=fp_tree["launches"],
                  fingerprint_tree={k: fp_tree[k] for k in (
                      "leaves", "rows", "tree_ms", "packed_ms")},
                  per_leaf={k: per_leaf[k] for k in (
                      "leaves", "per_leaf_ms", "packed_ms")},
                  dense_tree={k: fp_dense[k] for k in (
                      "ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by",
                      "tree_bytes", "rows")},
                  train_tree={k: tr["kernel"][k] for k in (
                      "ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by",
                      "tree_bytes", "rows")})
    ssd_row = _row("ssd_scan",
                   "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan/kernel.py:25",
                   launches["ssd_scan"], full["ssd"],
                   (seeded["ssd"], seeded["ssd_f32"],
                    seeded["ssd_f32_hymba"]))
    ssd_row["cuda_kernel_launches"] = ssd_cuda_kernels
    summary = {"kernels": [
        fp_row,
        _row("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:33",
             launches["flash_attention"], full["flash"],
             (seeded["flash"], seeded["flash_f32"],
              seeded["flash_f32_hymba"])),
        ssd_row,
    ]}
    card = subprocess.run(CARD_SHELL, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps(summary), flush=True)
    print(card[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _count_ops(fn) -> int:
    """Torch operations ``fn`` dispatches (each is at least one launch on
    the card, or a view)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as counter:
        fn()
    return counter.n


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _flat(tree).values())


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_ms(fn, reps: int, dev) -> float:
    """Host time per call of ``fn`` (which ends in device work), after one
    warm-up, synchronized before and after."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


if __name__ == "__main__":
    sys.exit(main())
