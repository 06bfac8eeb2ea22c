"""The port's SSD scan against the JAX package's: the ``ssd`` entry point
(its plain path, on CPU tensors), ``ssd_chunked`` and ``ssd_reference``
against the Pallas kernel in interpret mode and the JAX recurrence, on the
shapes of tests/test_kernels.py; then the pieces of the Mamba-2 block that
surround the scan (initial state, one decode step, the causal convs), and a
decay steep enough that exp above the chunk's diagonal overflows.

Tolerances are the JAX kernel tests' own: 2e-5 in f32 (sums in other
orders), 5e-2 in bf16 (one bf16 rounding of y). The CUDA kernel itself runs
only on a card: chip_smoke.py holds it against this plain path there. Here
an emulation of its three phases and rounding points (written below, not in
the package) is held against the Pallas kernel, to show that the tolerances
admit the design, and the wrapper's tile plan is tested.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd as jax_ssd  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 5e-2}

SSD_CASES = [
    # B, S, H, P, G, N, chunk   (tests/test_kernels.py)
    (2, 64, 3, 8, 1, 16, 16),
    (1, 128, 4, 16, 2, 8, 32),
    (2, 64, 4, 8, 4, 16, 64),
]


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _inputs(B, S, H, P, G, N, dtype, seed=1, a_scale=1.0):
    """(jax arrays, torch tensors) of x, dt, A, Bc, Cc, D, as the JAX kernel
    test draws them: x, Bc, Cc in ``dtype``, the rest f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((B, S, H)))
    A = (-np.exp(rng.standard_normal(H) * 0.5) * a_scale).astype(np.float32)
    Bc = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cc = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    D = (rng.standard_normal(H) * 0.1).astype(np.float32)
    typed = {0, 3, 4}
    arrs = (x, dt, A, Bc, Cc, D)
    jx = [jnp.asarray(a, getattr(jnp, dtype) if i in typed else jnp.float32)
          for i, a in enumerate(arrs)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype) if i in typed
                                 else torch.float32)
          for i, a in enumerate(arrs)]
    return jx, tx


def _err(got, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_matches_jax_kernel_and_reference(B, S, H, P, G, N, chunk,
                                              dtype):
    jx, tx = _inputs(B, S, H, P, G, N, dtype)
    y_k, h_k = jax_ssd(*jx, chunk=chunk, interpret=True)
    y_r, h_r = jssm.ssd_reference(*jx)
    n0, k0 = ops.ssd.launches, dict(ops.ssd.kernel_launches)
    y, h = ops.ssd(*tx, chunk=chunk)
    assert ops.ssd.launches == n0                  # CPU: the plain version
    assert ops.ssd.kernel_launches == k0
    assert y.dtype == tx[0].dtype and h.dtype == torch.float32
    assert h.shape == (B, H, P, N)
    for got, want in ((y, y_k), (h, h_k), (y, y_r), (h, h_r)):
        assert _err(got, want) < TOL[dtype]
    # the port's own oracle, against the JAX one
    y_pr, h_pr = tssm.ssd_reference(*tx)
    assert _err(y_pr, y_r) < TOL[dtype] and _err(h_pr, h_r) < TOL[dtype]


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_with_initial_state_matches_jax(G):
    jx, tx = _inputs(2, 48, 4, 8, G, 8, "float32", seed=4)
    h0 = np.random.default_rng(5).standard_normal((2, 4, 8, 8)) \
        .astype(np.float32)
    y_j, h_j = jssm.ssd_chunked(*jx, chunk=16, h0=jnp.asarray(h0))
    y_t, h_t = tssm.ssd_chunked(*tx, chunk=16, h0=torch.from_numpy(h0))
    assert _err(y_t, y_j) < TOL["float32"] and _err(h_t, h_j) < TOL["float32"]
    y_r, h_r = tssm.ssd_reference(*tx, h0=torch.from_numpy(h0))
    assert _err(y_t, y_r.numpy()) < TOL["float32"]
    assert _err(h_t, h_r.numpy()) < TOL["float32"]


def test_steep_decay_gives_no_nan():
    """|A| dt ~ 30 a step: exp(L_i - L_j) above the diagonal is inf, and a
    product with the causal mask there would be NaN."""
    jx, tx = _inputs(1, 64, 3, 8, 1, 16, "float32", seed=6, a_scale=40.0)
    y, h = ops.ssd(*tx, chunk=32)
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    y_r, h_r = jssm.ssd_reference(*jx)
    assert _err(y, y_r) < TOL["float32"] and _err(h, h_r) < TOL["float32"]


@pytest.mark.parametrize("G", [1, 3])
def test_decode_step_matches_jax(G):
    rng = np.random.default_rng(7)
    B, H, P, N = 2, 3, 8, 16
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((B, H)))
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bt, Ct = (rng.standard_normal((B, G, N)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    args = (h, x, dt, A, Bt, Ct, D)
    hj, yj = jssm.ssd_decode_step(*map(jnp.asarray, args))
    ht, yt = tssm.ssd_decode_step(*map(torch.from_numpy, args))
    assert _err(ht, hj) < 1e-5 and _err(yt, yj) < 1e-5


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2e-2)])
def test_causal_conv_and_step_match_jax(dtype, tol):
    rng = np.random.default_rng(8)
    B, S, H, P, K = 2, 9, 3, 4, 4
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    w = (rng.standard_normal((H, P, K)) / K).astype(np.float32)
    b = rng.standard_normal((H, P)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jssm.causal_conv(jnp.asarray(x, jd), jnp.asarray(w, jd),
                            jnp.asarray(b))
    got = tssm.causal_conv(torch.from_numpy(x).to(td),
                           torch.from_numpy(w).to(td), torch.from_numpy(b))
    assert got.dtype == td and _err(got, want) < tol
    # the step form, fed one position at a time, gives the same outputs
    state = torch.zeros((B, K - 1, H, P), dtype=td)
    jstate = jnp.zeros((B, K - 1, H, P), jd)
    for t in range(S):
        jstate, jy = jssm.causal_conv_step(jstate, jnp.asarray(x[:, t], jd),
                                           jnp.asarray(w, jd),
                                           jnp.asarray(b))
        state, y = tssm.causal_conv_step(state, torch.from_numpy(x[:, t])
                                         .to(td), torch.from_numpy(w).to(td),
                                         torch.from_numpy(b))
        assert _err(y, jy) < tol and _err(state, jstate) < tol
        assert _err(y, got[:, t].float().numpy()) < tol


def test_expand_groups_matches_jax():
    t = np.arange(2 * 5 * 2 * 3, dtype=np.float32).reshape(2, 5, 2, 3)
    for H in (2, 6):
        want = np.asarray(jssm._expand_groups(jnp.asarray(t), H))
        assert np.array_equal(tssm._expand_groups(torch.from_numpy(t), H)
                              .numpy(), want)


def test_wrapper_halves_the_chunk_and_refuses_bad_input():
    jx, tx = _inputs(1, 48, 2, 4, 1, 8, "float32", seed=9)
    # 48 % 32 != 0: the chunk halves to 16, as in the JAX kernel
    y, h = ops.ssd(*tx, chunk=32)
    y_j, h_j = jax_ssd(*jx, chunk=32, interpret=True)
    assert _err(y, y_j) < TOL["float32"] and _err(h, h_j) < TOL["float32"]
    assert ops.reference is tssm.ssd_reference
    meta = [t.to("meta") for t in tx]
    with pytest.raises(ValueError, match="device"):
        ops.ssd(*meta)
    with pytest.raises(ValueError):                  # dt of the wrong shape
        ops.ssd(tx[0], tx[1][:, :-1], *tx[2:])
    with pytest.raises(ValueError):                  # 2 heads over 3 groups
        bad = torch.zeros((1, 48, 3, 8))
        ops.ssd(tx[0], tx[1], tx[2], bad, bad, tx[5])


# ------------------------------------------------ the kernel's arithmetic
# What csrc/ssd_scan.cu computes, phase by phase, in f32 torch, at the
# chunk q that ops.tile_plan gives (the sequence zero-padded to whole
# chunks, as the kernel reads missing steps as zero):
#   1. chunk state: L = cumsum(dt A) in the chunk, w = exp(L_last - L) dt,
#      s = x^T (B w) per chunk and head, and the decay exp(L_last);
#   2. state passing: h_in of chunk c = the carried h; h <- decay h + s;
#   3. chunk scan: C.B^T once per group; scores = C.B^T exp(L_i - L_j) dt_j
#      selected for i >= j; y = scores.x + exp(L) (C . h_in^T) + D x.
# bf16: the scores enter scores.x and h_in enters C . h_in^T as three bf16
# terms, hi + mid + lo (which hold an f32's 24 bits), so the one rounding
# point is y's own, to bf16.
# f32 (``tf32_terms`` 3): each of the four products (x^T . (B w), C . B^T,
# C . h_in^T, scores . x) is taken as three TF32 products, hi.hi + hi.lo +
# lo.hi, of operands split as hi = tf32(v), lo = tf32(v - hi), lo.lo
# dropped; tf32(v) rounds to 10 mantissa bits, to nearest with ties away
# from zero (the kernel's hopper::to_tf32), here by the same bit masking
# (as tests/test_torch_flash_attention.py emulates the f32 flash kernel).
# ``tf32_terms`` 1: hi.hi alone, a single TF32 product. The kernel also
# sums each product 16 terms at a time (scores . x 8) on the tensor cores,
# whose adder truncates; that is not emulated (chip_smoke.py's f32 edge
# cases hold it).
def _bf16(t):
    return t.to(torch.bfloat16).float()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor,
             tf32_terms: int = 0) -> torch.Tensor:
    """einsum(eq, a, b): exact f32 (``tf32_terms`` 0), from one TF32
    product (1), or from three, hi.hi + hi.lo + lo.hi (3)."""
    if not tf32_terms:
        return torch.einsum(eq, a, b)
    ah, bh = _tf32(a), _tf32(b)
    if tf32_terms == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, ah, bh) + (torch.einsum(eq, ah, bl)
                                       + torch.einsum(eq, al, bh))


def _split3(t):
    hi = _bf16(t)
    mid = _bf16(t - hi)
    return hi + mid + _bf16(t - hi - mid)


def _emulate_kernel(x, dt, A, Bc, Cc, D, chunk, round_y=True, tf32_terms=0):
    B, S, H, P = x.shape
    G, N = Bc.shape[2], Bc.shape[3]
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    q = ops.tile_plan(B, S, H, P, G, N, x.dtype, chunk)["chunk"]
    nc = -(-S // q)
    rep = H // G
    bf16 = x.dtype == torch.bfloat16

    def chunks(t):
        pad = t.new_zeros((B, nc * q - S, *t.shape[2:]))
        return torch.cat([t.float(), pad.float()], 1).reshape(
            B, nc, q, *t.shape[2:])
    xs, dts, Bs, Cs = chunks(x), chunks(dt), chunks(Bc), chunks(Cc)
    Bh = Bs.repeat_interleave(rep, 3)                   # (B, nc, q, H, N)
    Ch = Cs.repeat_interleave(rep, 3)
    L = torch.cumsum(dts * A.float(), dim=2)            # (B, nc, q, H)
    # 1. chunk state
    w = torch.exp(L[:, :, -1:] - L) * dts
    own = _product("bcjhp,bcjhn->bchpn", xs * w[..., None], Bh, tf32_terms)
    decay = torch.exp(L[:, :, -1])                      # (B, nc, H)
    # 2. state passing
    h = torch.zeros((B, H, P, N))
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c, :, None, None] * h + own[:, c]
    h_in = torch.stack(h_in, 1)                         # (B, nc, H, P, N)
    # 3. chunk scan
    cb = _product("bcign,bcjgn->bcgij", Cs, Bs,
                  tf32_terms).repeat_interleave(rep, 2)
    Lh = L.permute(0, 1, 3, 2)                          # (B, nc, H, q)
    ii = torch.arange(q)
    below = ii[:, None] >= ii[None, :]
    scores = cb * torch.where(below, torch.exp(Lh[..., :, None]
                                               - Lh[..., None, :]),
                              torch.zeros(())) \
        * dts.permute(0, 1, 3, 2)[..., None, :]
    if bf16:
        scores, h_in = _split3(scores), _split3(h_in)
    y = _product("bchij,bcjhp->bcihp", scores, xs, tf32_terms) \
        + torch.exp(L)[..., None] * _product("bcihn,bchpn->bcihp", Ch, h_in,
                                             tf32_terms) \
        + xs * D.float()[:, None]
    y = y.reshape(B, nc * q, H, P)[:, :S]
    return (y.to(x.dtype) if round_y else y), h


EMULATION_CASES = SSD_CASES + [
    (2, 512, 4, 16, 2, 16, 128),      # G 2, four chunks of state passing
    (1, 192, 2, 16, 1, 32, 192),      # chunk 192: the kernel's 128 + 64
    (1, 200, 3, 20, 1, 10, 128),      # P, N not multiples of 8, short tail
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", EMULATION_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_arithmetic_matches_jax_kernel(B, S, H, P, G, N, chunk,
                                              dtype):
    jx, tx = _inputs(B, S, H, P, G, N, dtype, seed=2)
    y, h = _emulate_kernel(*tx, chunk=chunk)
    assert y.dtype == tx[0].dtype and h.shape == (B, H, P, N)
    y_k, h_k = jax_ssd(*jx, chunk=chunk, interpret=True)
    y_p, h_p = tssm.ssd_chunked(*tx, chunk=chunk)
    # relative to the output's scale (at least 1), as chip_smoke.py holds
    # the kernel: chunks of 128 reach magnitudes the 16-64 step chunks of
    # SSD_CASES do not, and f32 sums in other orders differ relatively
    for got, want in ((y, y_k), (h, h_k), (y, y_p.float().numpy()),
                      (h, h_p.numpy())):
        scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
        assert _err(got, want) / scale < TOL[dtype]


def _rel_err(got, want) -> float:
    """Max error relative to the output's scale (at least 1), as
    chip_smoke.py holds the kernel."""
    want = np.asarray(want, np.float32)
    return _err(got, want) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", EMULATION_CASES)
def test_f32_kernel_three_tf32_products_are_inside_the_tolerance(
        B, S, H, P, G, N, chunk):
    """The f32 kernel's arithmetic, every product as three TF32 products,
    against the Pallas kernel in interpret mode and the plain f32 path."""
    jx, tx = _inputs(B, S, H, P, G, N, "float32", seed=3)
    y, h = _emulate_kernel(*tx, chunk=chunk, tf32_terms=3)
    y_k, h_k = jax_ssd(*jx, chunk=chunk, interpret=True)
    y_p, h_p = tssm.ssd_chunked(*tx, chunk=chunk)
    for got, want in ((y, y_k), (h, h_k), (y, y_p.numpy()),
                      (h, h_p.numpy())):
        assert _rel_err(got, want) < TOL["float32"]


def test_one_tf32_product_is_outside_the_tolerance():
    """At mamba2-130m's N 128 one TF32 product a product (10 mantissa bits)
    misses 2e-5 by more than an order of magnitude: the split is needed,
    and three products are enough."""
    _, tx = _inputs(2, 512, 4, 64, 1, 128, "float32", seed=3)
    y_p, h_p = tssm.ssd_chunked(*tx, chunk=128)
    errs = {}
    for terms in (1, 3):
        y, h = _emulate_kernel(*tx, chunk=128, tf32_terms=terms)
        errs[terms] = max(_rel_err(y, y_p.numpy()), _rel_err(h, h_p.numpy()))
    assert errs[1] > 10 * TOL["float32"]
    assert errs[3] < TOL["float32"] / 10


def test_kernel_rounding_leaves_y_as_exact_as_f32():
    """Where |y| >= 16 one bf16 step is 0.125, above the 5e-2 tolerance: the
    f32 y before its rounding must be as close to the plain f32 sum as two
    f32 summation orders are, so that y lands on the plain version's bf16
    value but for rare ties. Three bf16 terms do it; with one (a bf16
    rounding of the scores, as flash attention rounds P) this emulation is
    four orders of magnitude further off, with two, over one."""
    _, tx = _inputs(1, 256, 4, 16, 1, 64, "bfloat16", seed=7)
    x, dt, A, Bc, Cc, D = tx
    Bc, Cc = (Bc.float() * 3).to(torch.bfloat16), \
        (Cc.float() * 3).to(torch.bfloat16)
    y, _ = _emulate_kernel(x, dt, A, Bc, Cc, D, chunk=128, round_y=False)
    exact = [t.float() for t in (x, dt, A, Bc, Cc, D)]
    y_p, _ = tssm.ssd_chunked(*exact, chunk=128)
    scale = float(y_p.abs().max())
    assert scale > 16
    assert _err(y, y_p.numpy()) / scale < 2e-6


def test_kernel_arithmetic_keeps_steep_decay_finite():
    """exp(L_i - L_j) is taken below the diagonal only: |A| dt ~ 30 a step
    overflows it above, and the emulation selects, never multiplies."""
    jx, tx = _inputs(1, 256, 3, 8, 1, 16, "bfloat16", seed=6, a_scale=40.0)
    y, h = _emulate_kernel(*tx, chunk=128)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(h).all())
    y_r, h_r = jssm.ssd_reference(*jx)
    assert _err(y, y_r) < TOL["bfloat16"] and _err(h, h_r) < TOL["bfloat16"]


@pytest.mark.parametrize("N", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_plan_fits_a_block(N, dtype):
    # hymba-1.5b's and mamba2-130m's scans: B 2, S 4096, H 25 / 24, P 64
    H = 25 if N == 16 else 24
    plan = ops.tile_plan(2, 4096, H, 64, 1, N, dtype, 128)
    assert all(b <= ops.MAX_SMEM_BYTES for b in plan["smem_bytes"].values())
    assert plan["smem_bytes"][3] == ops.smem_bytes(3, dtype, plan["chunk"],
                                                   N, 64, plan["groups"])
    # both dtypes keep Q 128 (f32 at N 128 too, since its kernels take
    # their products on the tensor cores), one chunk-scan block per SM
    assert plan["chunk"] == 128
    assert plan["scan_blocks"] <= ops.SMS
    if dtype == torch.bfloat16:
        # C.B^T once per 13 / 12 heads, as many warp groups side by side
        # as fit: 4 at N 16, 2 at N 128
        assert plan["groups"] == (4 if N == 16 else 2)
        assert ops.smem_bytes(3, dtype, 128, N, 64, plan["groups"] + 1) \
            > ops.MAX_SMEM_BYTES or plan["groups"] == ops.MAX_GROUPS
    else:                             # 16 warps on one head at a time
        assert plan["groups"] == 1
        assert plan["heads_per_block"] == (13 if N == 16 else 12)
    assert plan["chunks"] == 4096 // plan["chunk"]
    hs = plan["heads_per_block"]
    assert 1 <= hs <= H and plan["groups"] <= hs
    assert plan["scan_blocks"] == 2 * plan["chunks"] * -(-H // hs)
    assert plan["scratch_bytes"] == 4 * 2 * plan["chunks"] * H * (64 * N + 1)
    # shared memory grows with N and P: a wider state halves the chunk,
    # and a state no chunk leaves room for is refused
    wide = ops.tile_plan(1, 4096, 8, 128, 1, 256, dtype, 128)
    assert max(wide["smem_bytes"].values()) <= ops.MAX_SMEM_BYTES
    assert wide["chunk"] < 128
    # (f32 holds h_in 64 head-dim rows at a time: N 512 fits at chunk 16)
    wider = 512 if dtype == torch.bfloat16 else 1024
    with pytest.raises(ValueError, match=f"P 512 x N {wider}"):
        ops.tile_plan(1, 64, 2, 512, 1, wider, dtype, 64)
