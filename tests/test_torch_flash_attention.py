"""The port's flash attention entry point against the JAX package's: the
port's plain path (``flash_attention`` on CPU tensors) against the Pallas
kernel in interpret mode and against the JAX reference, on the shapes of
tests/test_kernels.py and on the cases the CUDA kernel treats apart: no
causal mask, an explicit scale, a ragged length, and a window under which a
row's first KV tile is wholly masked.

Tolerances are the JAX kernel tests' own: 3e-5 in f32 (the two frameworks
sum in other orders), 3e-2 in bf16 (one bf16 rounding of the output).
The CUDA kernel itself runs only on a card: chip_smoke.py holds it against
this plain path there.
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
}


def _inputs(B, Hq, KVH, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, D), (B, KVH, S, D), (B, KVH, S, D))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _err(got, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


def _run(B, Hq, KVH, S, D, win, qb, kb, dtype, causal=True, scale=None):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Hq, KVH, S, D, dtype)
    kw = dict(causal=causal, window=win, scale=scale)
    want_kernel = jax_flash(jq, jk, jv, q_block=qb, kv_block=kb,
                            interpret=True, **kw)
    want_ref = jax_reference(jq, jk, jv, **kw)
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, q_block=qb, kv_block=kb, **kw)
    assert ops.flash_attention.launches == n0      # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
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
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(c, c[:, :1], c[:, :1], window=0)
