"""All ten archs of the reference's registry, the port against the JAX
package on the same weights (drawn once by JAX, carried over bit for bit by
``params_from_jax``): the config copies, the init trees at smoke and full
width, f32 prefill and teacher-forced decode logits on each smoke config,
prefill against decode within the port, bf16 for minicpm3-4b (mixtral's
bf16 blocks are in tests/test_torch_moe.py), pixtral's prefix embeddings,
and mixtral's loss (ce + router aux) and every grad leaf.

One JAX prefill and one JAX decode scan per arch and dtype, shared by the
tests (the file runs on one worker).

Tolerances:
* f32: 1e-4 abs on logits and caches (the frameworks sum in other orders;
  the observed gap is ~1e-6). MoE decode at batch 2 has capacity 1, so
  most assignments drop; the port drops the same ones.
* bf16 (minicpm3-4b): 0.1 abs on logits, as tests/test_torch_models.py.
* prefill against decode (port only, f32): 1e-4; moe archs with
  ``capacity_factor = n_experts``, as the reference's own test, since
  capacity drops depend on how many tokens are routed together.
* loss 1e-5 abs, each grad leaf 1e-4 x max(1, max|g|), as
  tests/test_torch_train.py.
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

from repro import configs as jc  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.data import SyntheticTokens  # noqa: E402
from repro_torch import configs as tc  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.chunker import dtype_str  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 0.1
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 24

ARCHS = list(jc.ARCH_IDS)


@pytest.fixture(autouse=True)
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _cfgs(arch, dtype="float32", **kw):
    cfg = jc.get_smoke_config(arch).replace(param_dtype=dtype,
                                            compute_dtype=dtype, **kw)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


_RUNS = {}


def _run(arch, dtype):
    """JAX's and the port's prefill and teacher-forced decode on one smoke
    config, computed once per (arch, dtype)."""
    if (arch, dtype) in _RUNS:
        return _RUNS[arch, dtype]
    cfg, tcfg = _cfgs(arch, dtype)
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(cfg)
    jcache, jlogits = jax.jit(lambda p, t: jm.prefill(cfg, p, t))(
        jp, jnp.asarray(toks))

    @jax.jit
    def jdecode(p, t):
        def step(c, inp):
            return jm.decode_step(cfg, p, c, inp[0], inp[1])
        _, logits = jax.lax.scan(step, jm.init_cache(cfg, B, S + 4),
                                 (t.T, jnp.arange(S, dtype=jnp.int32)))
        return logits

    jdec = jdecode(jp, jnp.asarray(toks))
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        tcache, tlogits = tm.prefill(tcfg, tp, tt)
        cache, tdec = tm.init_cache(tcfg, B, S + 4, "cpu"), []
        for t in range(S):
            cache, logits = tm.decode_step(tcfg, tp, cache, tt[:, t], t)
            tdec.append(logits)
    _RUNS[arch, dtype] = dict(
        cfg=cfg, tcfg=tcfg, jp=jp, tp=tp, toks=toks,
        jax=(jax.tree.map(np.asarray, jcache), np.asarray(jlogits, np.float32),
             np.asarray(jdec, np.float32)),
        port=(tcache, tlogits, torch.stack(tdec)))
    return _RUNS[arch, dtype]


def test_arch_ids_are_the_references():
    assert tc.ARCH_IDS == jc.ARCH_IDS
    assert tc.list_archs() == jc.list_archs()
    with pytest.raises(KeyError):
        tc.get_smoke_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_jax(arch):
    for fn in (tc.get_config, tc.get_smoke_config):
        ref = getattr(jc, fn.__name__)(arch)
        assert dataclasses.asdict(fn(arch)) == dataclasses.asdict(ref)
    assert tc.get_config(arch).param_count() == \
        jc.get_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_jax(arch):
    """Paths, shapes and dtype strings: the smoke tree drawn on the CPU, and
    the full-width tree on the meta device against ``param_specs``."""
    cfg = jc.get_smoke_config(arch)
    want = jm.param_specs(cfg)
    got = tm.init_params(tc.get_smoke_config(arch),
                         torch.Generator().manual_seed(0), "cpu")
    w = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(want)}
    g = {k: (tuple(v.shape), dtype_str(v)) for k, v in _leaves(got)}
    assert g == w
    pad = (tm.padded_vocab(cfg) - cfg.vocab) * cfg.d_model * \
        (1 if cfg.tie_embeddings else 2)
    assert sum(int(np.prod(s)) for s, _ in g.values()) - pad == \
        cfg.param_count()
    full = jc.get_config(arch)
    specs = jm.param_specs(full)
    meta = tm.init_params(tc.get_config(arch), torch.Generator(), "meta")
    assert {k: (tuple(v.shape), dtype_str(v)) for k, v in _leaves(meta)} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(specs)}


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_logits_and_cache_match_jax(arch):
    r = _run(arch, "float32")
    (jcache, jlogits, _), (tcache, tlogits, _) = r["jax"], r["port"]
    assert tlogits.shape == (B, r["cfg"].vocab)
    assert np.abs(jlogits - _np(tlogits)).max() <= F32_TOL
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == jcache[name].shape, name
        assert np.abs(_np(jcache[name]) - _np(tcache[name])).max() \
            <= F32_TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_decode_logits_match_jax(arch):
    r = _run(arch, "float32")
    jdec, tdec = r["jax"][2], r["port"][2]
    assert tdec.shape == jdec.shape
    err = np.abs(jdec - _np(tdec)).max(axis=(1, 2))
    assert err.max() <= F32_TOL, err


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_agree(arch):
    """Prefill's last logits equal teacher-forced decode's."""
    cfg = tc.get_smoke_config(arch).replace(param_dtype="float32",
                                            compute_dtype="float32")
    if cfg.is_moe:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    params = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(_tokens(cfg)).long()
    with torch.inference_mode():
        _, logits_pf = tm.prefill(cfg, params, toks)
        cache = tm.init_cache(cfg, B, S + 4, "cpu")
        for t in range(S):
            cache, logits_dec = tm.decode_step(cfg, params, cache,
                                               toks[:, t], t)
    err = (logits_pf - logits_dec[:, :cfg.vocab]).abs().max()
    assert float(err) <= F32_TOL


def test_bf16_mla_prefill_and_decode_logits_match_jax():
    r = _run("minicpm3-4b", "bfloat16")
    (_, jlogits, jdec), (tcache, _, tdec) = r["jax"], r["port"]
    assert all(v.dtype == torch.bfloat16 for v in tcache.values())
    assert np.abs(jlogits - _np(r["port"][1])).max() <= BF16_TOL
    assert np.abs(jdec - _np(tdec)).max() <= BF16_TOL


def test_prefix_embeds_prefill_matches_jax():
    """pixtral-12b's stub frontend: patch embeddings take the first
    ``n_prefix_embeds`` positions of the prefill."""
    r = _run("pixtral-12b", "float32")
    cfg = r["cfg"]
    prefix = np.random.default_rng(4).standard_normal(
        (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    jcache, jlogits = jm.prefill(cfg, r["jp"], jnp.asarray(r["toks"]),
                                 jnp.asarray(prefix))
    with torch.inference_mode():
        tcache, tlogits = tm.prefill(r["tcfg"], r["tp"],
                                     torch.from_numpy(r["toks"]).long(),
                                     torch.from_numpy(prefix))
    assert np.abs(_np(jlogits) - _np(tlogits)).max() <= F32_TOL
    assert np.abs(_np(jlogits) - _np(r["port"][1])).max() > F32_TOL
    for name in jcache:
        assert np.abs(_np(jcache[name]) - _np(tcache[name])).max() <= F32_TOL


def test_mixtral_loss_with_router_aux_and_every_grad_leaf_match_jax():
    cfg, tcfg = _cfgs("mixtral-8x7b")
    batch = SyntheticTokens(cfg.vocab, 2, 32, seed=1).batch_at(0)
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(cfg, p, jbatch), has_aux=True)(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tl, taux, tg = value_and_grad(
        tcfg, tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(jaux["aux"]) > 0.5                # the router's loss counts
    for got, want in ((tl, jl), (taux["ce"], jaux["ce"]),
                      (taux["aux"], jaux["aux"])):
        assert abs(float(got) - float(want)) <= LOSS_TOL
    jflat = dict(_leaves(jax.tree.map(np.asarray, jg)))
    names = [k for k, _ in _leaves(tp)]
    assert names == sorted(jflat) and len(tg) == len(names)
    assert "blocks/router" in names
    for name, g in zip(names, tg):
        want = jflat[name]
        assert tuple(g.shape) == want.shape, name
        err = np.abs(_np(g) - want).max() / max(1.0, np.abs(want).max())
        assert err <= GRAD_TOL, name
