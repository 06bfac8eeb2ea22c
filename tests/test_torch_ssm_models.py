"""Model parity for the ssm (mamba2-130m) and hybrid (hymba-1.5b) families:
the port's model against the JAX package's on the same weights (drawn once
by JAX, carried over bit for bit by ``params_from_jax``), on each arch's
smoke config. hymba's smoke window (16) is shorter than the 24-token prompt,
so its prefill takes the banded attention path and its decode wraps the
ring.

Tolerances, as for the dense model (tests/test_torch_models.py):
* f32 (the algorithm): 1e-4 abs on logits and cache leaves; the observed
  gap is ~2e-6.
* bf16 (the working type): 0.1 abs; XLA and torch round bf16
  intermediates at other points (observed ~0.04).
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
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ARCHS = ["mamba2-130m", "hymba-1.5b"]
TOL = {"float32": 1e-4, "bfloat16": 0.1}
SSM_F32_LEAVES = ("A_log", "dt_bias", "D", "gate_norm", "conv_x_b",
                  "conv_B_b", "conv_C_b")


def _cfgs(arch, dtype):
    cfg = get_smoke_config(arch).replace(param_dtype=dtype,
                                         compute_dtype=dtype)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


_WEIGHTS = {}


def _weights(cfg):
    key = (cfg.name, cfg.param_dtype)
    if key not in _WEIGHTS:
        p = jm.init_params(cfg, jax.random.PRNGKey(0))
        _WEIGHTS[key] = (p, params_from_jax(jax.tree.map(np.asarray, p),
                                            "cpu"))
    return _WEIGHTS[key]


def _tokens(cfg, B=2, S=24):
    return np.random.default_rng(0).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _err(t, a) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(a, np.float32)).max())


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_and_decode_match_jax(arch, dtype):
    cfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _weights(cfg)
    toks = _tokens(cfg)
    B, S = toks.shape
    jcache, jlogits = jax.jit(lambda p, t: jm.prefill(cfg, p, t))(
        jp, jnp.asarray(toks))
    tcache, tlogits = tm.prefill(tcfg, tp, torch.from_numpy(toks).long())
    assert tlogits.shape == (B, cfg.vocab)
    assert _err(tlogits, jlogits) <= TOL[dtype]
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == jcache[name].shape, name
        assert _err(tcache[name], jcache[name]) <= TOL[dtype], name
    jc = jm.init_cache(cfg, B, S + 4)
    tc = tm.init_cache(tcfg, B, S + 4, "cpu")
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_step(cfg, p, c, t, pos))
    for t in range(S):
        jc, jl = jdec(jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t))
        tc, tl = tm.decode_step(tcfg, tp, tc,
                                torch.from_numpy(toks[:, t]).long(), t)
        assert _err(tl, jl) <= TOL[dtype], t
    for name in jc:          # every state the decode loop carried
        assert _err(tc[name], jc[name]) <= TOL[dtype], name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_prefill_decode_equivalence(arch, dtype, tol):
    """Teacher-forced decode ends at prefill's logits: each step must write
    the SSM state it computes back into the stacked cache."""
    cfg, tcfg = _cfgs(arch, dtype)
    _, tp = _weights(cfg)
    toks = torch.from_numpy(_tokens(cfg)).long()
    B, S = toks.shape
    pf_cache, logits_pf = tm.prefill(tcfg, tp, toks)
    cache = tm.init_cache(tcfg, B, S + 4, "cpu")
    for t in range(S):
        cache, logits_dec = tm.decode_step(tcfg, tp, cache, toks[:, t], t)
    err = (logits_pf.float() - logits_dec[:, :cfg.vocab].float()).abs().max()
    assert float(err) < tol
    assert float((cache["h"] - pf_cache["h"]).abs().max()) < tol


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    cfg = get_smoke_config(arch)
    want = jax.tree.map(np.asarray, jm.init_params(cfg, jax.random.PRNGKey(0)))
    got = tm.init_params(port_smoke(arch), torch.Generator().manual_seed(0),
                         "cpu")
    from repro_torch.core.chunker import dtype_str
    w = {k: (v.shape, str(v.dtype)) for k, v in _leaves(want)}
    g = {k: (tuple(v.shape), dtype_str(v)) for k, v in _leaves(got)}
    assert g == w
    pad = (tm.padded_vocab(cfg) - cfg.vocab) * cfg.d_model
    pad *= 1 if cfg.tie_embeddings else 2
    assert sum(int(np.prod(s)) for s, _ in g.values()) - pad == \
        cfg.param_count()
    # the draws follow the JAX init's laws: A = -exp(A_log) in [-16, -1],
    # softplus(dt_bias) in [1e-3, 0.1]
    core = got["blocks"]["ssm"] if arch == "hymba-1.5b" else got["blocks"]
    assert bool(((core["A_log"] >= 0) & (core["A_log"] <= np.log(16.0))).all())
    sp = torch.nn.functional.softplus(core["dt_bias"])
    assert bool(((sp > 9e-4) & (sp < 0.11)).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_jax(arch):
    import importlib
    mod = arch.replace("-", "_").replace(".", "_")
    jmod = importlib.import_module(f"repro.configs.{mod}")
    tmod = importlib.import_module(f"repro_torch.configs.{mod}")
    for fn in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(tmod, fn)()) == \
            dataclasses.asdict(getattr(jmod, fn)())
    assert port_config(arch) == tmod.config()


def test_full_width_hymba_param_count():
    cfg = port_config("hymba-1.5b")
    assert cfg.param_count() == 1_393_625_120


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_carries_f32_ssm_leaves_bit_for_bit(arch):
    cfg, _ = _cfgs(arch, "bfloat16")
    jp, tp = _weights(cfg)
    jcore = jp["blocks"]["ssm"] if arch == "hymba-1.5b" else jp["blocks"]
    tcore = tp["blocks"]["ssm"] if arch == "hymba-1.5b" else tp["blocks"]
    for name in SSM_F32_LEAVES:
        assert tcore[name].dtype == torch.float32, name
        assert np.array_equal(tcore[name].numpy(), np.asarray(jcore[name])), \
            name
    w = np.asarray(jcore["w_x"]).view(np.uint16)
    assert tcore["w_x"].dtype == torch.bfloat16
    assert np.array_equal(tcore["w_x"].view(torch.int16).numpy()
                          .view(np.uint16), w)


def test_layer_slices_nested_blocks():
    from repro_torch.models.model import _layer
    cfg, _ = _cfgs("hymba-1.5b", "float32")
    _, tp = _weights(cfg)
    one = _layer(tp, 1)
    assert one["ssm"]["w_x"].shape == tp["blocks"]["ssm"]["w_x"].shape[1:]
    assert torch.equal(one["attn"]["wq"], tp["blocks"]["attn"]["wq"][1])
    assert torch.equal(one["norm"], tp["blocks"]["norm"][1])
