#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) once on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of the repository

It builds the port's CUDA kernel from the sources in the checkout, holds it
bit-exactly against its plain torch version, then runs the serving path at
the full width of yi-6b (32 layers, d_model 4096, bf16, 12.1 GB of weights
drawn on the card from a seeded generator):

    save (full, fingerprinted) -> restore + serve -> incremental save
    -> sparse refresh -> serve

Each phase prints one line of its own numbers and raises on a failed check.
The last three lines are the kernels' summary (JSON), the card's name and
power limit as nvidia-smi gives them, and {"ok": true, "device": ...}.
Without a CUDA device it exits non-zero before printing any result. The
temporary store lives under the system temp directory and is removed at
exit.
"""
from __future__ import annotations

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
# integer operations per u32 lane of the fingerprint: 3 multiplies, 1 add,
# 2 xors and 1 shift in the mix, 1 xor and 1 add into the row's sums
FP_OPS_PER_LANE = 9
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


def phase_build():
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.fingerprint import ops
    t0 = time.perf_counter()
    paths = build_all({"fingerprint": ops.SOURCE})
    ops.load_library()
    secs = time.perf_counter() - t0
    with open(paths["fingerprint"] + ".ptxas.txt") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    log("build", seconds=secs, card=torch.cuda.get_device_name(0),
        cuda=torch.version.cuda, torch=torch.__version__,
        built=sorted(paths), ptxas=ptxas)


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


def phase_kernel_full(payload_union, chunk_bytes) -> dict:
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
    log("kernel_full", **res)
    return res


def phase_reference_check(dev) -> None:
    """The port's model on the card against the same model on the CPU, on
    a small f32 input (the CPU path is held against the JAX package by the
    tests). TF32 is off for f32 matmuls here and below."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, prefill
    from repro_torch.serve import Engine
    cfg = get_smoke_config("yi-6b").replace(param_dtype="float32",
                                            compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 24)))
    with torch.inference_mode():
        _, cpu_logits = prefill(cfg, params, toks)
        _, dev_logits = prefill(cfg, _to(params, dev), toks.to(dev))
    err = float((dev_logits.cpu() - cpu_logits).abs().max())
    check(err <= 1e-4, f"f32 prefill logits, card vs CPU: {err} > 1e-4")
    prompts = toks.numpy().astype(np.int32)
    t_cpu = Engine(cfg, params, max_len=40, device="cpu").generate(prompts, 8)
    t_dev = Engine(cfg, params, max_len=40, device=dev).generate(prompts, 8)
    check(np.array_equal(t_cpu.tokens, t_dev.tokens),
          "greedy tokens differ between card and CPU")
    log("reference_check", prefill_max_abs_err=err, tol=1e-4,
        tokens_equal=True)


def serving_path(cfg, params, dev, chunk_bytes: int, batch: int,
                 prompt_len: int, new_tokens: int) -> dict:
    """save -> restore + serve -> incremental save -> sparse refresh ->
    serve, through the entry points a user calls. Returns the counts the
    caller checks against the kernels."""
    from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
    from repro_torch.ckpt.manager import unflatten_tree
    from repro_torch.core import tree_pack_index
    from repro_torch.kernels.fingerprint.ops import fingerprint_leaves
    from repro_torch.launch.serve import load_params, make_prompts, serve
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serve import Engine, changed_tensor_paths

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        policy = CheckpointPolicy(use_fingerprints=True,
                                  chunk_bytes=chunk_bytes)
        mgr = CheckpointManager(tmp, cfg.name, policy)
        union = {}
        for tree in mgr._payloads(params, {}, 0).values():
            union.update(tree)
        _, total_chunks, _ = tree_pack_index(union, chunk_bytes)
        if dev.type == "cuda":
            out["kernel"] = phase_kernel_full(union, chunk_bytes)

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

        t0 = time.perf_counter()
        restored, step = load_params(cfg, tmp, dev)
        load_s = time.perf_counter() - t0
        check(step == 0, "restored the wrong step")
        flat_r, flat_p = _flat(restored), _flat(params)
        check(sorted(flat_r) == sorted(flat_p) and all(
            torch.equal(flat_r[k], flat_p[k]) for k in flat_p),
            "restored weights differ from the saved ones")
        prompts = make_prompts(cfg, batch, prompt_len)
        eng, res, gen_s = serve(cfg, restored, prompts, new_tokens, dev)
        check(res.tokens.shape == (batch, new_tokens), "wrong token shape")
        check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
              "token out of range")
        check(bool(np.isfinite(res.logits_last).all()), "non-finite logits")
        log("serve", load_seconds=load_s, seconds=gen_s, batch=batch,
            prompt_len=prompt_len, new_tokens=new_tokens,
            tokens_per_s=res.tokens.size / gen_s,
            first_tokens=res.tokens[0, :8].tolist())

        # a few leaves change on the device: one layer of wk, and final_norm
        layer = min(3, cfg.n_layers - 1)
        params1 = dict(params)
        params1["blocks"] = dict(params["blocks"])
        wk = params["blocks"]["wk"].clone()
        wk[layer] += 0.01
        params1["blocks"]["wk"] = wk
        params1["final_norm"] = params["final_norm"] * 1.5
        layer_bytes = wk[layer].numel() * wk.element_size()
        check((layer * layer_bytes) % chunk_bytes == 0,
              "the edited layer must start on a chunk boundary")
        # chunks that changed: the layer's, final_norm's and the step's
        expect_chunks = -(-layer_bytes // chunk_bytes) + 1 + 1
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

        t0 = time.perf_counter()
        changed = changed_tensor_paths(mgr.store, mgr.image, mgr.tag_of(0),
                                       mgr.tag_of(1))
        check(changed == {"params/blocks/wk", "params/final_norm",
                          "opt/__step__"}, f"sparse plan {changed}")
        names = sorted(n for n in changed if n.startswith("params/"))
        part = mgr.store.load_image_payload(mgr.image, mgr.tag_of(1),
                                            names=names)
        tree = unflatten_tree({k[len("params/"):]: v for k, v in part.items()})
        swapped = eng.refresh(tree, changed={n[len("params/"):] for n in names},
                              step=1)
        refresh_s = time.perf_counter() - t0
        res2 = eng.generate(prompts, new_tokens)
        out["launches"] = fingerprint_leaves.launches
        # ---- end of the main path
        res_ref = Engine(cfg, params1, max_len=eng.max_len,
                         device=dev).generate(prompts, new_tokens)
        check(len(part) == 2 and swapped == 2, "refresh loaded extra leaves")
        check(np.array_equal(res2.tokens, res_ref.tokens),
              "tokens after the sparse refresh differ from a direct engine")
        log("refresh", seconds=refresh_s, changed=sorted(changed),
            tensors_loaded=len(part), leaves_swapped=swapped,
            tokens_equal=True,
            tokens_moved=int((res2.tokens != res.tokens).sum()))

        with torch.inference_mode():
            toks = torch.as_tensor(prompts, device=dev).long()
            pf_ms = _host_ms(lambda: prefill(cfg, eng.params, toks), 3, dev)
            cache = init_cache(cfg, batch, eng.max_len, dev)
            tok = toks[:, -1]
            step = lambda: decode_step(cfg, eng.params, cache, tok, prompt_len)
            dec_ms = _host_ms(step, 5, dev)
            dec_ops = _count_ops(step)
        log("split", prefill_ms=pf_ms, decode_step_ms=dec_ms, batch=batch,
            prompt_len=prompt_len, decode_step_ops=dec_ops,
            ms_per_op=dec_ms / dec_ops)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_build()
    phase_kernel_edges(dev)
    phase_reference_check(dev)

    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log("init", seconds=time.perf_counter() - t0,
        param_bytes=_nbytes(params), layers=cfg.n_layers,
        d_model=cfg.d_model, dtype=cfg.param_dtype)
    out = serving_path(cfg, params, dev, chunk_bytes=1 << 20, batch=4,
                       prompt_len=128, new_tokens=32)
    check(out["save2_launches"] == 1,
          f"incremental save made {out['save2_launches']} kernel launches")
    check(out["launches"] >= 1, "the main path never launched the kernel")

    kernel = out["kernel"]
    summary = {"kernels": [{
        "name": "fingerprint", "route": "cuda",
        "source": "src/repro_torch/kernels/fingerprint/csrc/fingerprint.cu",
        "replaces": "src/repro/kernels/fingerprint/kernel.py:44",
        "launches": out["launches"], "check": "bit-exact",
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": None,
        "tree_bytes": kernel["tree_bytes"], "rows": kernel["rows"]}]}
    card = subprocess.run(CARD_SHELL, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()
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
