"""The per-layer counterparts the port lacked under the reference's names,
against the JAX package on the same inputs: the family dispatchers
``init_block``/``apply_block``/``decode_block`` on one smoke config of each
of the five families (f32, one layer of weights drawn by JAX and carried
over), ``ssm_cache_init`` called with the reference's positional
arguments, ``attention_reference`` (causal, windowed, GQA) and
``dense_init``.

Tolerances:
* ``apply_block``/``decode_block``, f32: 1e-4 abs on outputs and caches,
  as tests/test_torch_archs.py (the frameworks sum in other orders);
* ``attention_reference``, f32: 1e-5 abs;
* ``dense_init`` cannot match JAX's bits: its shape and dtype are held
  exactly, its values to the truncation bound 2 x d_in ** -0.5, and its
  standard deviation within 2% of the truncated normal's (0.8796 x
  d_in ** -0.5) and of JAX's draw at the same shape (131,072 samples: the
  sampling error of a standard deviation is ~0.2%).
TF32 is off for f32 matrix products.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.convert import params_from_jax, tree_to_numpy  # noqa: E402
from repro_torch.core.chunker import dtype_str  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

F32_TOL = 1e-4
REF_TOL = 1e-5
FAMILIES = {"dense": "yi-6b", "moe": "mixtral-8x7b", "mla": "minicpm3-4b",
            "ssm": "mamba2-130m", "hybrid": "hymba-1.5b"}
B, S = 2, 12


@pytest.fixture(autouse=True)
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _cfgs(family):
    cfg = get_smoke_config(FAMILIES[family]).replace(
        param_dtype="float32", compute_dtype="float32")
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _err(t, a) -> float:
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    return float(np.abs(np.asarray(t, np.float32)
                        - np.asarray(a, np.float32)).max())


def _layer(family, seed=0):
    cfg, tcfg = _cfgs(family)
    jp = jb.init_block(cfg, jax.random.PRNGKey(seed))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_block_tree_matches_jax(family):
    cfg, tcfg = _cfgs(family)
    want = jax.eval_shape(lambda: jb.init_block(cfg, jax.random.PRNGKey(0)))
    got = tb.init_block(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), dtype_str(v)) for k, v in _leaves(got)} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(want)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_apply_block_matches_jax(family):
    cfg, tcfg, jp, tp = _layer(family)
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jx, jaux, jcache = jb.apply_block(cfg, jp, jnp.asarray(x),
                                      jnp.asarray(pos), collect_cache=True)
    with torch.no_grad():
        tx, taux, tcache = tb.apply_block(tcfg, tp, torch.from_numpy(x),
                                          torch.from_numpy(pos.copy()),
                                          collect_cache=True)
    assert _err(tx, jx) <= F32_TOL
    assert abs(float(taux) - float(jaux)) <= F32_TOL
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == jcache[name].shape, name
        assert _err(tcache[name], jcache[name]) <= F32_TOL, name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_block_matches_jax(family):
    """One decode step against a cache of random contents, at a position
    past the cache's length (the ring has wrapped)."""
    cfg, tcfg, jp, tp = _layer(family)
    C = 16
    rng = np.random.default_rng(2)
    shapes = jax.eval_shape(lambda: jb.init_layer_cache(cfg, B, C))
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in shapes.items()}
    x_t = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    pos = C + 3
    jcache, jx = jb.decode_block(cfg, jp, {k: jnp.asarray(v)
                                           for k, v in cache.items()},
                                 jnp.asarray(x_t), jnp.int32(pos))
    with torch.no_grad():
        tcache, tx = tb.decode_block(
            tcfg, tp, {k: torch.from_numpy(v.copy()) for k, v in
                       cache.items()}, torch.from_numpy(x_t), pos)
    assert _err(tx, jx) <= F32_TOL
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        assert _err(tcache[name], jcache[name]) <= F32_TOL, name


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_cache_init_takes_the_references_positional_arguments(arch):
    cfg = get_smoke_config(arch)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    want = jb.ssm_cache_init(cfg, 3, 7)
    got = tb.ssm_cache_init(tcfg, 3, 7)
    assert {k: (tuple(v.shape), dtype_str(v)) for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert all(v.device.type == "cpu" and not v.any() for v in got.values())
    assert tb.ssm_cache_init(tcfg, 3, device="meta")["h"].is_meta


# B, S, Hq, KVH, D, causal, window
ATTN_CASES = {
    "causal": (2, 24, 4, 4, 16, True, None),
    "causal-gqa": (2, 24, 8, 2, 16, True, None),
    "windowed-gqa": (2, 24, 4, 2, 16, True, 6),
    "bidirectional-gqa": (1, 17, 6, 3, 8, False, None),
    "scaled-windowed": (1, 20, 4, 1, 32, False, 5),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_reference_matches_jax(case):
    Bq, Sq, Hq, KVH, D, causal, window = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((Bq, Sq, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, Sq, KVH, D)).astype(np.float32)
            for _ in range(2))
    scale = 0.3 if case.startswith("scaled") else None
    want = ja.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, scale=scale)
    got = ta.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window, scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _err(got, want) <= REF_TOL


def test_attention_reference_bf16_keeps_its_dtype():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 16, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = ja.attention_reference(*(jnp.asarray(a, jnp.bfloat16)
                                    for a in (q, k, v)), window=4)
    got = ta.attention_reference(*(torch.from_numpy(a).bfloat16()
                                   for a in (q, k, v)), window=4)
    assert got.dtype == torch.bfloat16
    assert _err(got, np.asarray(want, np.float32)) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_init_shape_dtype_bound_and_spread(dtype):
    d_in, d_out = 256, 512
    got = tl.dense_init(torch.Generator().manual_seed(0), d_in, d_out,
                        tl.as_torch_dtype(dtype), "cpu")
    want = jl.dense_init(jax.random.PRNGKey(0), d_in, d_out, jnp.dtype(dtype))
    assert tuple(got.shape) == want.shape == (d_in, d_out)
    assert dtype_str(got) == str(want.dtype) == dtype
    g = tree_to_numpy(got.float())
    w = np.asarray(want, np.float32)
    bound = 2 * d_in ** -0.5
    assert np.abs(g).max() <= bound * (1 + 2 ** -7)     # bf16's rounding
    truncated_std = 0.8796 * d_in ** -0.5
    assert abs(g.std() / truncated_std - 1) < 0.02
    assert abs(g.std() / w.std() - 1) < 0.02
    assert abs(g.mean()) < 0.02 * truncated_std
