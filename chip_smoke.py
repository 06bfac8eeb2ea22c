#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) once on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of the repository

It builds the port's three CUDA libraries from the sources in the
checkout (one nvcc each, all at once), logs each library's registers and
spills as ptxas reports them (and fails if ptxas serialised a kernel's
wgmma, or if one of the SSD scan's kernels spills), and holds each kernel
against its plain torch version on edge cases: the fingerprint bit-exactly, flash attention (both its f32 and its
bf16 tensor-core kernel) and the SSD scan within the JAX kernel tests'
tolerances. It checks the f32 models of each family on the card against
the CPU, then runs the serving path

    save (full, fingerprinted) -> restore + serve -> incremental save
    -> sparse refresh -> serve

at the full width of yi-6b (dense, 12.1 GB of bf16 weights) and of
hymba-1.5b (hybrid, 2.8 GB, 4096-token prompts), weights drawn on the card
from a seeded generator. On every layer of hymba's prefill it then calls
the flash attention and SSD scan entry points on the tensors the model
computes and holds them against the model's own results (the served
models, as in the JAX package, run the plain attention and scan), and
times each kernel beside its bound, its plain version and, for attention,
``scaled_dot_product_attention``; last at yi-6b's attention shape (bf16
and f32) and mamba2-130m's scan shape. The SSD scan runs as three CUDA
kernels a call (chunk state, state passing, chunk scan); its launches
count calls, and each of the three CUDA kernels is counted as well.

Each phase prints one line of its own numbers and raises on a failed check.
The last three lines are the kernels' summary (JSON), the card's name and
power limit as nvidia-smi gives them, and {"ok": true, "device": ...}.
Without a CUDA device it exits non-zero before printing any result. The
temporary stores live under the system temp directory and are removed at
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
BF16_TENSOR_OPS_PER_S = 989e12     # dense bf16 on the tensor cores
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
    plans = {d: fa_ops.tile_plan(d)["smem_bytes"] for d in fa_ops.HEAD_DIMS}
    lib = fa_ops.load_library()
    check(all(lib.fa_bf16_smem_bytes(d) == b for d, b in plans.items()),
          "ops.tile_plan disagrees with the kernel's shared memory")
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


def phase_fingerprint_full(payload_union, chunk_bytes) -> dict:
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
    log("fingerprint_full", **res)
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
# cases run again with x, Bc and Cc each a contiguous view one element into
# its storage: no longer 16-byte aligned, so the bf16 kernels take their
# plain loads and stores at shapes that would allow 16-byte ones
SSD_UNALIGNED_CASES = [
    (2, 256, 4, 64, 2, 16, 128, 1.0),
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
    g = torch.Generator(device=dev).manual_seed(21)
    worst = {}
    for case in FA_EDGE_CASES:
        B, Hq, KVH, S, D, win, causal, scale = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(g, B, Hq, KVH, S, D, dtype, dev)
            kw = dict(causal=causal, window=win, scale=scale)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = _max_err(got, reference(q, k, v, **kw))
            check(err < FA_TOL[dtype], f"flash {case} {dtype}: {err}")
            name = str(dtype).split(".")[-1]
            worst[name] = max(worst.get(name, 0.0), err)
    log("kernel_edges_flash", cases=len(FA_EDGE_CASES), dtypes=2,
        max_abs_err=worst, tol={"float32": 3e-5, "bfloat16": 3e-2})


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
    g = torch.Generator(device=dev).manual_seed(22)
    worst = {}
    cases = [(c, False) for c in SSD_EDGE_CASES] + \
        [(c, True) for c in SSD_UNALIGNED_CASES]
    for case, unaligned in cases:
        B, S, H, P, G, N, chunk, a_scale = case
        for dtype in (torch.float32, torch.bfloat16):
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
            w["rel_vs_plain"] = max(w["rel_vs_plain"], *errs)
            w["abs_vs_reference"] = max(w["abs_vs_reference"],
                                        _max_err(y, y_r), _max_err(h, h_r))
    log("kernel_edges_ssd", cases=len(cases), dtypes=2,
        max_err=worst, tol={"float32": 2e-5, "bfloat16": 5e-2})


def _ops_rate(dtype) -> float:
    return BF16_TENSOR_OPS_PER_S if dtype == torch.bfloat16 \
        else ALU32_OPS_PER_S


def _bound(nbytes: int, ops: float, dtype) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / _ops_rate(dtype) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bytes": nbytes, "ops": ops}


def flash_bound(q, k, causal: bool, window) -> dict:
    """Unmasked (query, key) pairs x 4 D operations (2 D for q.k, 2 D for
    p.v); q, k, v read once and o written once."""
    B, Hq, S, D = q.shape
    pos = np.arange(S)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(S, int)
    hi = pos + 1 if causal else np.full(S, S)
    pairs = B * Hq * int((hi - lo).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return _bound(nbytes, 4.0 * D * pairs, q.dtype)


def ssd_bound(x, Bc, chunk: int) -> dict:
    """Per chunk of Q steps with T = Q (Q + 1) / 2 pairs i >= j: C.B^T 2 N T
    a group, and a head 2 P T (scores.x) + 3 T (decay, dt) + 2 Q N P
    (incoming state) + 2 Q N P (state update) + 2 Q P (skip). Bytes: x, dt,
    B, C read once, y and h written once."""
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
    return _bound(nbytes, ops, x.dtype)


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
    ``phase_ms``, each phase's device time alone, the same way."""
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
    check(res["max_abs_err"] < SSD_TOL[x.dtype],
          f"ssd at {res['shape']}: {res['max_abs_err']}")
    call = lambda: ssd(x, dt, A, Bc, Cc, D, chunk=chunk)  # noqa: E731
    res["ms"] = cuda_ms(call, reps)
    res["graph_ms"] = graph_ms(call, reps)
    runs, _, _ = phase_launches(x, dt, A, Bc, Cc, D, chunk)
    res["phase_ms"] = {name: graph_ms(run, reps) for name, run in runs}
    res["plain_ms"] = cuda_ms(
        lambda: ssd_chunked(x, dt, A, Bc, Cc, D, chunk=chunk), 2)
    res["library_ms"] = None
    res.update(ssd_bound(x, Bc, chunk))
    return res


def phase_seeded_shapes(dev) -> dict:
    """The kernels at the widths of the repo's other models: yi-6b's
    attention (causal, no window) in bf16 and in f32 (the f32 kernel, SDPA
    in f32 beside it; TF32 is off), and mamba2-130m's scan (N 128)."""
    g = torch.Generator(device=dev).manual_seed(5)
    flash = {}
    for dtype, reps in ((torch.bfloat16, 20), (torch.float32, 5)):
        q, k, v = _flash_inputs(g, 1, 32, 4, 4096, 128, dtype, dev)
        flash[dtype] = time_flash(q, k, v, causal=True, window=None,
                                  reps=reps)
        flash[dtype]["model"] = "yi-6b"
        del q, k, v
        torch.cuda.empty_cache()
    args = _ssd_inputs_seeded(g, 2, 4096, 24, 64, 1, 128, 1.0,
                              torch.bfloat16, dev)
    scan = time_ssd(*args, chunk=128)
    scan["model"] = "mamba2-130m"
    log("kernel_seeded", flash=flash[torch.bfloat16],
        flash_f32=flash[torch.float32], ssd=scan)
    return {"flash": flash[torch.bfloat16], "flash_f32": flash[torch.float32],
            "ssd": scan}


def phase_reference_check(dev) -> None:
    """The port's models on the card against the same models on the CPU, on
    a small f32 input, one arch of each family the port serves (the CPU
    path is held against the JAX package by the tests). TF32 is off for f32
    matmuls here and below."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, prefill
    from repro_torch.serve import Engine
    errs = {}
    for arch in ("yi-6b", "mamba2-130m", "hymba-1.5b"):
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
    log("reference_check", prefill_max_abs_err=errs, tol=1e-4,
        tokens_equal=True)


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
    from repro_torch.models.model import _layer, embed_tokens
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
        for i in range(cfg.n_layers):
            p = _layer(params, i)
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
            x, _ = apply_hybrid_block(cfg, p, x, positions)
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


def serving_path(cfg, params, dev, chunk_bytes: int, batch: int,
                 prompt_len: int, new_tokens: int, edit: str) -> dict:
    """save -> restore + serve -> incremental save -> sparse refresh ->
    serve, through the entry points a user calls. Between the saves, one
    layer of the leaf ``edit`` and ``final_norm`` change on the device, and
    the sparse plan must name exactly those two leaves. Returns the counts
    the caller checks against the kernels, the engine and the prompts."""
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
            out["kernel"] = phase_fingerprint_full(union, chunk_bytes)

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

        # a few leaves change on the device: one layer of ``edit``, and
        # final_norm
        layer = min(3, cfg.n_layers - 1)
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

        t0 = time.perf_counter()
        changed = changed_tensor_paths(mgr.store, mgr.image, mgr.tag_of(0),
                                       mgr.tag_of(1))
        check(changed == {f"params/{edit}", "params/final_norm",
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
    out.update(engine=eng, prompts=prompts)
    return out


def run_model(arch: str, dev, edit: str, batch: int, prompt_len: int,
              new_tokens: int) -> dict:
    """One model at full width, weights drawn on the card from a seeded
    generator, through ``serving_path``; checks the fingerprint launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log("init", arch=arch, seconds=time.perf_counter() - t0,
        param_bytes=_nbytes(params), layers=cfg.n_layers,
        d_model=cfg.d_model, dtype=cfg.param_dtype)
    out = serving_path(cfg, params, dev, chunk_bytes=1 << 20, batch=batch,
                       prompt_len=prompt_len, new_tokens=new_tokens,
                       edit=edit)
    check(out["save2_launches"] == 1,
          f"incremental save made {out['save2_launches']} kernel launches")
    check(out["launches"] >= 1, "the main path never launched the kernel")
    out["cfg"] = cfg
    return out


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
            "bytes_bound_ms", "ops_bound_ms") if k in o} for o in others]
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_build()
    phase_kernel_edges(dev)
    phase_flash_edges(dev)
    phase_ssd_edges(dev)
    phase_reference_check(dev)

    # slice 1: the dense family at full width
    yi = run_model("yi-6b", dev, edit="blocks/wk", batch=4, prompt_len=128,
                   new_tokens=32)
    fp, fp_launches = yi["kernel"], yi["launches"]
    del yi
    torch.cuda.empty_cache()

    # slice 2: the hybrid family at full width; then the two kernels' own
    # entry points on the tensors its prefill computes
    hy = run_model("hymba-1.5b", dev, edit="blocks/ssm/w_x", batch=2,
                   prompt_len=4096, new_tokens=32)
    cfg = hy["cfg"]
    path = phase_kernel_path(cfg, hy["engine"].params, hy["prompts"], dev)
    full = phase_kernel_full(path["layer0"], cfg)
    fp_hybrid_launches, launches = hy["launches"], path["launches"]
    ssd_cuda_kernels = path["ssd_cuda_kernels"]
    del hy, path
    torch.cuda.empty_cache()
    seeded = phase_seeded_shapes(dev)

    fp_row = _row("fingerprint",
                  "src/repro_torch/kernels/fingerprint/csrc/fingerprint.cu",
                  "src/repro/kernels/fingerprint/kernel.py:44",
                  fp_launches, dict(fp, shape=[fp["rows"]],
                                       model="yi-6b", library_ms=None))
    fp_row.update(check="bit-exact", tree_bytes=fp["tree_bytes"],
                  launches_hybrid_path=fp_hybrid_launches)
    ssd_row = _row("ssd_scan",
                   "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan/kernel.py:25",
                   launches["ssd_scan"], full["ssd"], (seeded["ssd"],))
    ssd_row["cuda_kernel_launches"] = ssd_cuda_kernels
    summary = {"kernels": [
        fp_row,
        _row("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:33",
             launches["flash_attention"], full["flash"],
             (seeded["flash"], seeded["flash_f32"])),
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
