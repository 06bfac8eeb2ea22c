"""The port's flash attention entry point against the JAX package's: the
port's plain path (``flash_attention`` on CPU tensors) against the Pallas
kernel in interpret mode and against the JAX reference, on the shapes of
tests/test_kernels.py, on gemma-2b's head dim 256 with one KV head, on
minicpm3-4b's MLA (q and k at 96, v at 64), and on the cases the CUDA
kernel treats apart: no causal mask, an explicit scale, a ragged length, a
window under which a row's first KV tile is wholly masked, and a window
below 1.

Tolerances are the JAX kernel tests' own: 3e-5 in f32 (the two frameworks
sum in other orders), 3e-2 in bf16 (one bf16 rounding of the output).
The CUDA kernels themselves run only on a card: chip_smoke.py holds them
against this plain path there. Here an emulation of the bf16 kernel's
rounding points (written below, not in the package) is held against the
Pallas kernel, to show that the bf16 tolerance admits the design; one of
the f32 kernel's arithmetic (each product as three TF32 products of
operands split into tf32 hi and lo parts, by bit masking) is held against
the JAX reference and the Pallas kernel at the unchanged f32 tolerance,
and one TF32 product a multiply shown to miss it; both emulations take
each supported (D, Dv) pair's tiles from the wrapper's tile plans and the
window as the wrapper encodes it; and the tile plans, the window's
encoding and the input checks are tested.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ops import reference as jax_reference  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

TOL = {"float32": 3e-5, "bfloat16": 3e-2}

FA_CASES = [
    # B, Hq, KVH, S, D, window, qb, kb   (tests/test_kernels.py)
    (2, 4, 2, 128, 64, None, 64, 64),
    (1, 4, 4, 256, 32, None, 128, 64),
    (2, 8, 2, 128, 64, 32, 32, 32),
    (1, 2, 1, 64, 128, None, 64, 64),
]
EXTRA_CASES = {
    # name: (B, Hq, KVH, S, D, window, qb, kb, causal, scale)
    "not_causal": (1, 4, 1, 64, 32, None, 32, 32, False, None),
    "window_not_causal": (1, 4, 2, 64, 32, 24, 32, 32, False, None),
    "explicit_scale": (1, 4, 2, 64, 64, None, 32, 32, True, 0.3),
    # row r sees keys r-19..r: for rows 51..63 of the second 32-row tile
    # the first 32-key tile (0..31) is wholly masked
    "first_tile_masked": (1, 2, 1, 64, 32, 20, 32, 32, True, None),
    "ragged_length": (1, 4, 2, 40, 64, 16, 512, 512, True, None),
    # gemma-2b's head dim (256) on one KV head (MQA): causal, windowed,
    # and not causal with a scale
    "d256_causal": (1, 4, 1, 64, 256, None, 32, 32, True, None),
    "d256_window": (1, 4, 1, 96, 256, 24, 32, 32, True, None),
    "d256_not_causal_scale": (1, 4, 1, 64, 256, None, 32, 32, False, 0.2),
}


def _inputs(B, Hq, KVH, S, D, dtype, seed=0, Dv=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, D), (B, KVH, S, D), (B, KVH, S, Dv or D))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _err(got, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


def _run(B, Hq, KVH, S, D, win, qb, kb, dtype, causal=True, scale=None,
         Dv=None):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Hq, KVH, S, D, dtype, Dv=Dv)
    kw = dict(causal=causal, window=win, scale=scale)
    want_kernel = jax_flash(jq, jk, jv, q_block=qb, kv_block=kb,
                            interpret=True, **kw)
    want_ref = jax_reference(jq, jk, jv, **kw)
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, q_block=qb, kv_block=kb, **kw)
    assert ops.flash_attention.launches == n0      # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == (B, Hq, S, Dv or D)
    assert _err(got, want_kernel) < TOL[dtype]
    assert _err(got, want_ref) < TOL[dtype]


@pytest.mark.parametrize("B,Hq,KVH,S,D,win,qb,kb", FA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel(B, Hq, KVH, S, D, win, qb, kb,
                                            dtype):
    _run(B, Hq, KVH, S, D, win, qb, kb, dtype)


@pytest.mark.parametrize("case", sorted(EXTRA_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_edge_cases_match_jax(case, dtype):
    B, Hq, KVH, S, D, win, qb, kb, causal, scale = EXTRA_CASES[case]
    _run(B, Hq, KVH, S, D, win, qb, kb, dtype, causal=causal, scale=scale)


def test_reference_is_the_plain_version():
    assert ops.reference is flash_attention_ref
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 6, 3, 48, 16, "float32", seed=3)
    for kw in (dict(), dict(window=7), dict(causal=False, scale=0.5)):
        assert _err(flash_attention_ref(tq, tk, tv, **kw),
                    jax_reference(jq, jk, jv, **kw)) < TOL["float32"]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 8, 16), device="meta")
    k = torch.zeros((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q, k, k)
    c = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError):                  # 3 heads over 2
        ops.flash_attention(c, torch.zeros((1, 2, 8, 16)),
                            torch.zeros((1, 2, 8, 16)))
    with pytest.raises(ValueError):                  # lengths differ
        ops.flash_attention(c, torch.zeros((1, 1, 9, 16)),
                            torch.zeros((1, 1, 9, 16)))
    with pytest.raises(ValueError):                  # v's length differs
        ops.flash_attention(c, c[:, :1], torch.zeros((1, 1, 9, 16)))
    # a window below 1 is the reference's uniform average on the plain
    # path, and the kernels take it (``kernel_window``)
    ops.flash_attention(c, c[:, :1], c[:, :1], window=0)
    ops.check_kernel_inputs(*(torch.zeros((1, 2, 8, 64)) for _ in range(3)))


@pytest.mark.parametrize("S", [1, 8, 40])
def test_kernel_window_encodes_the_reference_mask(S):
    """The wrapper hands the kernels ``kernel_window(window, S)``: S for no
    window, a window below 1 as itself, cut to [-S, S]. Under the kernels'
    rule (keys with query - key >= window masked, and key > query when
    causal) that is the plain version's mask for every window."""
    assert ops.kernel_window(None, S) == S
    assert [ops.kernel_window(w, S) for w in (0, -3, 1, S, S + 5, -S - 9)] \
        == [0, max(-3, -S), 1, S, S, -S]
    pos = torch.arange(S)
    diff = pos[:, None] - pos[None, :]
    for causal in (True, False):
        for window in (None, 1, 3, S - 1, S, S + 7, 0, -1, -4, -S, -S - 9):
            want = torch.ones((S, S), dtype=torch.bool)
            if causal:
                want &= diff >= 0
            if window is not None:
                want &= diff < window
            got = (diff < ops.kernel_window(window, S)) & \
                ((diff >= 0) if causal else True)
            assert torch.equal(got, want), (causal, window)


# (B, Hq, KVH, S, D, Dv): minicpm3-4b's MLA shape (q and k at 96, v at 64),
# which the kernels take, and one they do not
DV_CASES = [(1, 2, 1, 64, 96, 64), (2, 4, 2, 40, 32, 16)]


@pytest.mark.parametrize("B,Hq,KVH,S,D,Dv", DV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v_head_dim_unlike_k_matches_jax_kernel(B, Hq, KVH, S, D, Dv, dtype):
    """The reference takes Dv = v.shape[-1] and returns (B, Hq, S, Dv)."""
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, D), (B, KVH, S, D), (B, KVH, S, Dv))]
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs)
    for kw in (dict(), dict(window=24), dict(causal=False, scale=0.2)):
        want = jax_flash(jq, jk, jv, q_block=32, kv_block=32,
                         interpret=True, **kw)
        got = ops.flash_attention(tq, tk, tv, **kw)
        assert got.shape == (B, Hq, S, Dv) == want.shape
        assert _err(got, want) < TOL[dtype]
        assert _err(got, jax_reference(jq, jk, jv, **kw)) < TOL[dtype]
    if (D, Dv) in ops.HEAD_DIMS:
        ops.check_kernel_inputs(tq, tk, tv)
    else:
        with pytest.raises(ValueError,
                           match=rf"v \({B}, {KVH}, {S}, {Dv}\)"):
            ops.check_kernel_inputs(tq, tk, tv)


@pytest.mark.parametrize("window", [0, -3])
def test_window_below_one_matches_jax(window):
    """Every key is masked: each row averages all values uniformly, in the
    Pallas kernel, the JAX reference and the port's plain path alike."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 4, 2, 64, 32, "float32", seed=5)
    got = ops.flash_attention(tq, tk, tv, window=window)
    want = jax_flash(jq, jk, jv, q_block=32, kv_block=32, interpret=True,
                     window=window)
    assert _err(got, want) < TOL["float32"]
    assert _err(got, jax_reference(jq, jk, jv, window=window)) \
        < TOL["float32"]
    uniform = torch.repeat_interleave(tv, 2, dim=1).mean(dim=2, keepdim=True)
    assert _err(got, uniform.expand_as(got).numpy()) < TOL["float32"]


# ---------------------------------------------- the bf16 kernel's rounding
# What csrc/flash_attention.cu's bf16 path computes, step by step, in f32
# torch: query blocks of ``tile_plan``'s rows; of each, only the KV tiles
# (``tile_plan``'s keys: 128, or 80 at D 256) holding a key some row may
# see, in order (every tile under a window below 1, which ``kernel_window``
# passes as itself); scores q.k^T in f32, then scaled by scale * log2(e),
# masked entries -1e30, keys past S -inf; m, l and acc in f32 with exp2;
# p rounded to bf16 before p.v (v exact in bf16, products summed in f32),
# l summed from the f32 p; out = acc / max(l, 1e-30) in bf16.
LOG2E = 1.4426950408889634


def _emulate_kernel(q, k, v, *, rows, keys, qk, pv, causal=True,
                    window=None, scale=None):
    """The kernels' tiling and online softmax over (rows x keys) tiles, in
    f32 torch; ``qk(q, k^T)`` and ``pv(p, v)`` are their products."""
    B, Hq, S, D = q.shape
    Dv = v.shape[-1]
    G = Hq // k.shape[1]
    w = ops.kernel_window(window, S)
    scale_log2 = (scale if scale is not None else D ** -0.5) * LOG2E
    qf = q.float()
    kf = torch.repeat_interleave(k, G, dim=1).float()
    vf = torch.repeat_interleave(v, G, dim=1).float()
    R, K = rows, keys
    out = torch.empty((B, Hq, S, Dv), dtype=q.dtype)
    for q0 in range(0, S, R):
        r = torch.arange(q0, q0 + R)
        qb = torch.zeros((B, Hq, R, D))
        qb[:, :, :min(R, S - q0)] = qf[:, :, q0:q0 + R]
        k_lo, k_hi = 0, S
        if w >= 1:
            k_lo = max(0, q0 - w + 1)
            k_hi = min(S, q0 + R) if causal else S
        m = torch.full((B, Hq, R), -1e30)
        l = torch.zeros((B, Hq, R))
        acc = torch.zeros((B, Hq, R, Dv))
        for k0 in range(k_lo // K * K, k_hi, K):
            c = torch.arange(k0, k0 + K)
            kb = torch.zeros((B, Hq, K, D))
            vb = torch.zeros((B, Hq, K, Dv))
            kb[:, :, :min(K, S - k0)] = kf[:, :, k0:k0 + K]
            vb[:, :, :min(K, S - k0)] = vf[:, :, k0:k0 + K]
            s = qk(qb, kb.transpose(-1, -2)) * scale_log2
            ok = r[:, None] - c[None, :] < w
            if causal:
                ok = ok & (r[:, None] >= c[None, :])
            s = torch.where(ok, s, torch.tensor(-1e30))
            s = torch.where(c[None, :] < S, s, torch.tensor(float("-inf")))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + pv(p, vb)
            m = m_new
        res = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, :, q0:q0 + R] = res[:, :, :S - q0].to(q.dtype)
    return out


def _emulate_bf16_kernel(q, k, v, **kw):
    plan = ops.tile_plan(q.shape[-1], v.shape[-1])
    return _emulate_kernel(
        q, k, v, rows=plan["q_rows"], keys=plan["kv_rows"],
        qk=torch.matmul,
        pv=lambda p, vb: p.to(torch.bfloat16).float() @ vb, **kw)


EMULATION_CASES = {
    **{f"fa_{i}": (*c, True, None) for i, c in enumerate(FA_CASES)},
    **EXTRA_CASES,
    # a row block whose first visited 128-key tile is wholly masked
    "first_tile_masked_128": (1, 2, 1, 256, 64, 40, 128, 128, True, None),
    # 9 tiles of 128 keys, a window: the last row block visits all 9
    "nine_tiles_window": (1, 4, 2, 1152, 64, 1000, 128, 128, True, None),
    # D 256 on one KV head: a ragged last tile (224 = 2 x 80 + 64), and a
    # band whose first visited tile is wholly masked
    "d256_ragged": (1, 4, 1, 224, 256, None, 32, 32, True, None),
    "d256_first_tile_masked": (1, 2, 1, 256, 256, 40, 64, 64, True, None),
    # the bf16 kernel's 80-key tiles under 128-row blocks: S 208 = 2 x 80 +
    # 48, the causal diagonal inside tiles 1 and 2; and GQA with a band
    # whose lower edge cuts tiles
    "d256_diagonal_mid_tile": (1, 4, 1, 208, 256, None, 64, 64, True,
                               None),
    "d256_band_mid_tile": (1, 4, 2, 208, 256, 77, 64, 64, True, None),
    # the f32 pair plan scores each 32-key tile in two 16-key halves, one
    # a warp: S 200 = 6 x 32 + 8 and 3 x 64 + 8 (the last tile's second
    # half wholly past S, a ragged row block), a band's lower edge inside
    # halves under GQA; and S 20, one tile, the second half past S
    "d256_band_mid_16": (1, 4, 2, 200, 256, 45, 64, 64, True, None),
    "d256_one_ragged_tile": (1, 4, 1, 20, 256, None, 32, 32, False, 0.2),
    # the f32 plans' 128-key tiles at D 32 and 32-key tiles at D 128: a
    # ragged last tile and row block, the diagonal and a band's lower edge
    # inside tiles
    "d32_band_mid_128": (1, 4, 2, 300, 32, 77, 64, 64, True, None),
    "d128_band_mid_32": (1, 4, 2, 200, 128, 45, 64, 64, True, None),
    # a window below 1: causal, every row averages all S values; not
    # causal, rows see the keys at least 1 - window ahead, the last none
    "window_zero": (1, 4, 2, 192, 64, 0, 64, 64, True, None),
    "window_negative_not_causal": (1, 4, 2, 192, 32, -5, 64, 64, False,
                                   None),
}
# minicpm3-4b's MLA: q and k at 96, v at 64 (a ragged 128-key tile, the
# block's scale; and a band under GQA), as (case, Dv)
EMULATION_DV_CASES = {
    "mla_96_64": ((1, 4, 4, 192, 96, None, 64, 64, True, 96 ** -0.5), 64),
    "mla_96_64_window": ((2, 4, 2, 192, 96, 50, 64, 64, True, None), 64),
    "mla_96_64_window_zero": ((1, 2, 1, 64, 96, 0, 32, 32, False, None),
                              64),
    # a ragged 64-key last tile and a 64-row last block, the causal
    # diagonal on GQA at the MLA's scale 96^-0.5
    "mla_96_64_ragged": ((1, 4, 2, 320, 96, None, 64, 64, True,
                          96 ** -0.5), 64),
    # 64-key tiles under 128-row blocks: S 300 = 4 x 64 + 44 and 2 x 128 +
    # 44 (a ragged last tile and row block), the causal diagonal and a
    # band's lower edge inside tiles; and not causal, a scale, S 150
    "mla_96_64_band_mid": ((1, 4, 2, 300, 96, 45, 64, 64, True,
                            96 ** -0.5), 64),
    "mla_96_64_not_causal_ragged": ((1, 2, 1, 150, 96, None, 32, 32,
                                     False, 0.3), 64),
}


def _emulation_case(name):
    """-> (B, Hq, KVH, S, D, window, qb, kb, causal, scale, Dv)"""
    if name in EMULATION_DV_CASES:
        case, dv = EMULATION_DV_CASES[name]
        return (*case, dv)
    case = EMULATION_CASES[name]
    return (*case, case[4])


ALL_EMULATION_CASES = sorted(EMULATION_CASES) + sorted(EMULATION_DV_CASES)


@pytest.mark.parametrize("case", ALL_EMULATION_CASES)
def test_bf16_kernel_rounding_is_inside_the_tolerance(case):
    B, Hq, KVH, S, D, win, qb, kb, causal, scale, Dv = _emulation_case(case)
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Hq, KVH, S, D, "bfloat16", Dv=Dv)
    kw = dict(causal=causal, window=win, scale=scale)
    want = jax_flash(jq, jk, jv, q_block=qb, kv_block=kb, interpret=True,
                     **kw)
    got = _emulate_bf16_kernel(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, S, Dv)
    assert _err(got, want) < TOL["bfloat16"]
    # and the emulation is of the same function as the plain version
    assert _err(got, flash_attention_ref(tq, tk, tv, **kw).float().numpy()) \
        < TOL["bfloat16"]


@pytest.mark.parametrize("d,dv", ops.HEAD_DIMS)
def test_tile_plan_fits_a_block(d, dv):
    plan = ops.tile_plan(d, dv)
    assert plan["smem_bytes"] <= ops.SMEM_MAX   # the most a block may use
    # two consumer warpgroups of 64 rows (a wgmma's m)
    assert plan["consumer_rows"] == 64
    assert plan["q_rows"] == plan["consumers"] * plan["consumer_rows"]
    assert plan["consumers"] == 2
    # whole wgmma tiles: S's n (a multiple of 8, at most 256) is the key
    # tile, P.V's k-steps of 16 keys cover it; 80 keys at D 256, else 128
    assert plan["kv_rows"] % 16 == 0 and plan["kv_rows"] <= 256
    assert plan["kv_rows"] == (80 if d == 256 else 128)
    # K and V rings of at least 2 stages each: K and V of tile j + 1 load
    # while tile j computes; on rings of their own at (256, 256), where
    # only 2 fit
    assert plan["k_stages"] >= 2 and plan["v_stages"] >= 2
    assert plan["k_stages"] == plan["v_stages"]
    assert plan["split"] == (d == 256)
    assert plan["box_row_bytes"] in (64, 128)  # a TMA / wgmma swizzle
    box_cols = plan["box_row_bytes"] // 2
    # Q and K in whole boxes (D 96: two, the last 32 columns zero), V too;
    # each box of a K or V tile on the swizzle's 1024-byte period
    assert plan["qk_cols"] % box_cols == 0 and \
        0 <= plan["qk_cols"] - d < box_cols and dv % box_cols == 0
    assert plan["kv_rows"] * plan["box_row_bytes"] % 1024 == 0
    assert d % 16 == 0                         # whole k-steps of wgmma
    stage = plan["kv_rows"] * (plan["qk_cols"] + dv) * 2
    tiles = plan["q_rows"] * plan["qk_cols"] * 2 + plan["k_stages"] * stage
    # a full and an empty barrier a stage of each ring, Q's, 1 KB to align
    rings = 2 if plan["split"] else 1
    assert plan["smem_bytes"] == tiles + 8 * (2 * rings * plan["k_stages"]
                                              + 1) + 1024
    # a stage more would not fit (or the ring is at its 4)
    assert plan["k_stages"] == 4 or \
        plan["smem_bytes"] + stage + 16 * rings > ops.SMEM_MAX
    for pair in ((80, 80), (32, 16), (64, 96)):
        with pytest.raises(ValueError, match="head dims"):
            ops.tile_plan(*pair)


def test_kernel_input_checks():
    def qkv(dtype, d=16, offset=0, dv=None):
        n = 2 * 8 * d
        base = torch.zeros(n + offset, dtype=dtype)
        return base[offset:].view(1, 2, 8, d), torch.zeros(
            (1, 1, 8, d), dtype=dtype), torch.zeros((1, 1, 8, dv or d),
                                                    dtype=dtype)
    ops.check_kernel_inputs(*qkv(torch.bfloat16, 64))
    ops.check_kernel_inputs(*qkv(torch.float32, 32, offset=1))  # f32: no TMA
    # gemma-2b's (256, 256) and minicpm3-4b's (96, 64)
    for d, dv in ((256, 256), (96, 64)):
        ops.check_kernel_inputs(*qkv(torch.bfloat16, d, dv=dv))
        ops.check_kernel_inputs(*qkv(torch.float32, d, offset=1, dv=dv))
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.check_kernel_inputs(*qkv(torch.bfloat16, 64, offset=1))
    # the rest are refused, the message naming the pairs the kernels take
    for d, dv in ((16, 16), (80, 80), (96, 96), (64, 96), (256, 128)):
        with pytest.raises(ValueError, match=r"head dims \(D, Dv\) in "
                           r"\(\(32, 32\), .*\(256, 256\), \(96, 64\)\), "
                           rf"not \({d}, {dv}\)"):
            ops.check_kernel_inputs(*qkv(torch.bfloat16, d, dv=dv))
    with pytest.raises(ValueError, match="f32 or all bf16"):
        ops.check_kernel_inputs(*qkv(torch.float16, 64))


# ----------------------------------------------- the f32 kernel's 3xTF32
# What csrc/flash_attention.cu's f32 path computes, in f32 torch: query
# blocks over KV tiles as ``f32_tile_plan`` fixes them (128 rows over 128,
# 64 or 32 keys; 64 x 32 at D 256), in ``_emulate_kernel``'s order and
# masking (where a value is split, once a block or once a warp, and which
# warp scores which keys, leave the arithmetic as it is); each product
# (q.k^T, then p.v) taken as three TF32 products, hi.hi + hi.lo + lo.hi, of
# operands split as hi = tf32(x), lo = tf32(x - hi), lo.lo dropped;
# tf32(x) rounds to 10 mantissa bits, to nearest with ties away from zero
# (the kernel's hopper::to_tf32, cvt.rna's rounding), here by the same bit
# masking. Scores are scaled by scale * log2(e) after the product, the
# online softmax in f32 with exp2. The CUDA kernel also keeps each sum
# short on the tensor cores, whose adder truncates; that is not emulated
# (the card's edge cases in chip_smoke.py hold it).


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _three_products(a: torch.Tensor, b: torch.Tensor,
                    terms: int = 3) -> torch.Tensor:
    """a @ b from TF32 products: hi.hi + hi.lo + lo.hi (``terms`` 1: hi.hi
    alone, a single TF32 product)."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def _emulate_f32_kernel(q, k, v, *, terms=3, **kw):
    plan = ops.f32_tile_plan(q.shape[-1], v.shape[-1])
    product = lambda a, b: _three_products(a, b, terms)  # noqa: E731
    return _emulate_kernel(q, k, v, rows=plan["q_rows"],
                           keys=plan["kv_rows"], qk=product, pv=product,
                           **kw)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # a tf32 value
    half = 2.0 ** -11                            # half its last unit
    x = torch.tensor([one, one + half, 1.0 + half, -(1.0 + half),
                      1.0 + half * 0.99, 3.0, 0.0, float("inf"),
                      2.0 - 2.0 ** -23], dtype=torch.float32)
    got = _tf32(x).tolist()
    assert got == [one, one + 2 * half, 1.0 + 2 * half, -(1.0 + 2 * half),
                   1.0, 3.0, 0.0, float("inf"), 2.0]
    assert not (_tf32(torch.randn(1000)).view(torch.int32) & 0x1fff).any()


@pytest.mark.parametrize("case", ALL_EMULATION_CASES)
def test_f32_kernel_three_tf32_products_are_inside_the_tolerance(case):
    B, Hq, KVH, S, D, win, qb, kb, causal, scale, Dv = _emulation_case(case)
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Hq, KVH, S, D, "float32", Dv=Dv)
    kw = dict(causal=causal, window=win, scale=scale)
    got = _emulate_f32_kernel(tq, tk, tv, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, S, Dv)
    assert _err(got, jax_reference(jq, jk, jv, **kw)) < TOL["float32"]
    assert _err(got, jax_flash(jq, jk, jv, q_block=qb, kv_block=kb,
                               interpret=True, **kw)) < TOL["float32"]


@pytest.mark.parametrize("case", ["fa_0", "d256_causal", "mla_96_64"])
def test_one_tf32_product_is_outside_the_tolerance(case):
    """The split is what meets 3e-5: one TF32 product a multiply misses,
    at each tile plan."""
    B, Hq, KVH, S, D, win, qb, kb, causal, scale, Dv = _emulation_case(case)
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Hq, KVH, S, D, "float32", Dv=Dv)
    kw = dict(causal=causal, window=win, scale=scale)
    got = _emulate_f32_kernel(tq, tk, tv, terms=1, **kw)
    assert _err(got, jax_reference(jq, jk, jv, **kw)) > TOL["float32"]


@pytest.mark.parametrize("d,dv", ops.HEAD_DIMS)
def test_f32_tile_plan_fits_a_block(d, dv):
    plan = ops.f32_tile_plan(d, dv)
    assert plan["smem_bytes"] <= ops.SMEM_MAX   # the most a block may use
    rows, keys, pair = plan["q_rows"], plan["kv_rows"], plan["strip_warps"]
    qk, vs = plan["qk_stride"], plan["v_stride"]
    # m16 strips of rows, ``strip_warps`` warps a strip, each with whole
    # n8 tiles of O's columns, in pairs (a 16-byte fragment load of V)
    assert rows % 16 == 0 and plan["warps"] == rows // 16 * pair == 8
    assert d % 16 == 0 and (dv // pair) % 16 == 0
    # S's keys in groups of 4 n8 tiles (split once) or halves of whole n8
    # tiles (pairs of warps), its 16-column blocks in rounds of
    # ``column_blocks``
    assert keys % (32 if plan["split_once"] else 16) == 0
    assert (d // 16) % plan["column_blocks"] == 0
    threads = 32 * plan["warps"]
    # whole rounds of 16-byte copies: Q's rows, K's and V's
    assert all(n % (4 * threads) == 0
               for n in (rows * d, keys * d, keys * dv))
    # the raw rows' strides: conflict-free 16-byte loads of rows g, g + 1
    # (Q, K), 4-byte loads of rows 2t, 2t + 1 at column g (V)
    assert qk == d + 16 and qk % 32 == 16
    assert vs == dv + 4 and (2 * vs) % 32 == 8
    raw = plan["raw_stages"] * keys * (qk + vs)
    if plan["split_once"]:
        # one raw stage split into one split stage; every thread splits
        # whole rounds of fragment units (Q's, K's, V's)
        assert (pair, plan["raw_stages"], plan["split_stages"]) == (1, 1, 1)
        assert all(n % threads == 0
                   for n in (rows * d // 8, keys * d // 4, keys * dv // 4))
        q_words = 2 * rows * d                       # Q's hi and lo planes
        split = 2 * keys * (d + dv)                  # K's and V's
        # Q's raw tile is staged over the split and raw stages
        assert rows * qk <= split + raw
        assert plan["smem_bytes"] == 4 * (q_words + split + raw)
    else:
        # the pair plan: raw Q, a ring of 2, and each warp's half of P (4
        # words a lane an n8 tile) and its row maxima (2 a lane)
        assert (pair, plan["raw_stages"], plan["split_stages"]) == (2, 2, 0)
        xch = plan["warps"] * (keys // 16 * 128 + 64)
        assert plan["smem_bytes"] == 4 * (rows * qk + raw + xch)
    # the pair plan at gemma-2b's head dims, where Q's planes and a warp's
    # whole O do not fit; split once everywhere else
    assert plan["split_once"] == ((d, dv) != (256, 256))
    for pair in ((80, 80), (32, 16), (64, 96)):
        with pytest.raises(ValueError, match="head dims"):
            ops.f32_tile_plan(*pair)
