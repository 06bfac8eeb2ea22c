"""Model parity: the port's dense model against the JAX package's on the
same weights (drawn once by JAX, carried over bit for bit by
``params_from_jax``), on yi-6b's smoke config, a sliding-window variant, a
variant with several KV blocks and one with scaled, tied embeddings.

Tolerances:
* f32 (the algorithm): 1e-4 abs on logits. The two frameworks sum in other
  orders; the observed gap is ~1e-6.
* bf16 (the working type): 0.1 abs on logits of magnitude <= 4, a few bf16
  ulps there; XLA and torch round bf16 intermediates at other points.

TF32 is off for f32 matrix products (``torch.backends.cuda.matmul`` and
``torch.backends.cudnn``), set by a fixture; it matters only on a card,
where the same flags are set by chip_smoke.py.
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

from repro import models as jm  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 0.1

VARIANTS = {
    "dense": dict(),
    "sliding_window": dict(window=8, q_block=8, kv_block=8),
    "multi_kv_block": dict(kv_block=8),
    "scaled_tied_embeddings": dict(embed_scale=True, tie_embeddings=True),
}
# bf16 runs on yi's own layout: the scaled, tied variant reaches logits of
# ~14, where one bf16 ulp is 0.0625, so its check is the f32 one
BF16_VARIANTS = ["dense", "multi_kv_block", "sliding_window"]


def _cases(bf16_tol):
    return [(v, "float32", F32_TOL) for v in sorted(VARIANTS)] + \
        [(v, "bfloat16", bf16_tol) for v in BF16_VARIANTS]


@pytest.fixture(autouse=True)
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _cfgs(variant, dtype):
    cfg = get_smoke_config("yi-6b").replace(
        param_dtype=dtype, compute_dtype=dtype, **VARIANTS[variant])
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _weights(cfg):
    p = jm.init_params(cfg, jax.random.PRNGKey(0))
    return p, params_from_jax(jax.tree.map(np.asarray, p), "cpu")


def _tokens(cfg, B=2, S=24):
    return np.random.default_rng(0).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("variant,dtype,tol", _cases(BF16_TOL))
def test_prefill_and_decode_logits_match_jax(variant, dtype, tol):
    cfg, tcfg = _cfgs(variant, dtype)
    jp, tp = _weights(cfg)
    toks = _tokens(cfg)
    B, S = toks.shape
    jcache, jlogits = jax.jit(lambda p, t: jm.prefill(cfg, p, t))(
        jp, jnp.asarray(toks))
    tcache, tlogits = tm.prefill(tcfg, tp, torch.from_numpy(toks).long())
    assert tlogits.shape == (B, cfg.vocab)
    assert np.abs(np.asarray(jlogits, np.float32) - _np(tlogits)).max() <= tol
    for name in ("k", "v"):
        assert np.abs(np.asarray(jcache[name], np.float32)
                      - _np(tcache[name])).max() <= tol
    jc = jm.init_cache(cfg, B, S + 4)
    tc = tm.init_cache(tcfg, B, S + 4, "cpu")
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_step(cfg, p, c, t, pos))
    for t in range(S):
        jc, jl = jdec(jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t))
        tc, tl = tm.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]).long(), t)
        assert tl.shape == jl.shape
        assert np.abs(np.asarray(jl, np.float32) - _np(tl)).max() <= tol, t


@pytest.mark.parametrize("variant,dtype,tol", _cases(5e-2))
def test_prefill_decode_equivalence(variant, dtype, tol):
    """Prefill's last logits equal teacher-forced decode's (the bf16 bound
    is the JAX package's own, tests/test_models.py)."""
    cfg, tcfg = _cfgs(variant, dtype)
    _, tp = _weights(cfg)
    toks = torch.from_numpy(_tokens(cfg)).long()
    B, S = toks.shape
    _, logits_pf = tm.prefill(tcfg, tp, toks)
    cache = tm.init_cache(tcfg, B, S + 4, "cpu")
    for t in range(S):
        cache, logits_dec = tm.decode_step(tcfg, tp, cache, toks[:, t], t)
    err = (logits_pf.float() - logits_dec[:, :cfg.vocab].float()).abs().max()
    assert float(err) < tol


def test_init_params_tree_matches_jax():
    cfg = get_smoke_config("yi-6b")
    want = jax.tree.map(np.asarray, jm.init_params(cfg, jax.random.PRNGKey(0)))
    got = tm.init_params(port_smoke("yi-6b"), torch.Generator().manual_seed(0),
                         "cpu")

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tree[k]

    from repro_torch.core.chunker import dtype_str
    w = {k: (v.shape, str(v.dtype)) for k, v in leaves(want)}
    g = {k: (tuple(v.shape), dtype_str(v)) for k, v in leaves(got)}
    assert g == w
    pad = (tm.padded_vocab(cfg) - cfg.vocab) * cfg.d_model * 2
    assert sum(int(np.prod(s)) for s, _ in g.values()) - pad == \
        cfg.param_count()


def test_config_copy_matches_jax():
    for fn in ("config", "smoke_config"):
        from repro.configs import yi_6b as jy
        from repro_torch.configs import yi_6b as ty
        assert dataclasses.asdict(getattr(ty, fn)()) == \
            dataclasses.asdict(getattr(jy, fn)())
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(jm.ModelConfig)]


def test_other_families_are_refused():
    """A family the reference does not know ("rnn") is refused by every
    entry point; the reference's five are all ported."""
    from repro.models.blocks import FAMILY_INIT as JAX_FAMILIES
    from repro_torch.models.blocks import FAMILY_INIT
    assert sorted(FAMILY_INIT) == sorted(JAX_FAMILIES)
    cfg = port_smoke("yi-6b").replace(family="rnn")
    params = tm.init_params(port_smoke("yi-6b"), torch.Generator(), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="rnn"):
        tm.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="rnn"):
        tm.prefill(cfg, params, toks)
    with pytest.raises(NotImplementedError, match="rnn"):
        tm.decode_step(cfg, params, {}, toks[:, 0], 0)


@pytest.mark.parametrize("impl", ["blockwise", "banded"])
def test_attention_matches_jax(impl):
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    kw = dict(window=12, impl=impl, kv_block=8, q_block=8)
    want = np.asarray(ja.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw))
    got = ta.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), **kw).numpy()
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_layers_match_jax(act):
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) * 0.2
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5))
    t = torch.from_numpy
    pairs = [
        (jl.gated_mlp(x, wg, wu, wd, act),
         tl.gated_mlp(t(x), t(wg), t(wu), t(wd), act)),
        (jl.rms_norm(x, scale), tl.rms_norm(t(x), t(scale))),
        (jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6),
         tl.apply_rope(t(x), t(pos.copy()), 5e6)),
    ]
    for want, got in pairs:
        assert np.abs(np.asarray(want) - got.numpy()).max() <= F32_TOL
    with pytest.raises(ValueError):
        tl.gated_mlp(t(x), t(wg), t(wu), t(wd), "relu")
