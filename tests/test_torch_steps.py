"""The prefill and decode step factories against the JAX package's on a 1x1
CPU mesh, for a dense smoke config (yi-6b) and a hybrid one (hymba-1.5b,
windowed attention beside the SSM state), on f32 weights drawn by JAX and
carried over: prefill logits and cache, then three greedy decode steps
(logits and cache after each) from each side's own prefill cache spliced
into a decode cache. Tolerance: 1e-4 abs, as tests/test_torch_archs.py.
TF32 is off for f32 matrix products."""
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
from repro.launch.mesh import make_mesh, mesh_context  # noqa: E402
from repro.train import make_decode_step as jax_decode_step  # noqa: E402
from repro.train import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill_step  # noqa: E402

TOL = 1e-4
B, S, CACHE_LEN, STEPS = 2, 12, 16, 3


@pytest.fixture(autouse=True)
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _err(t, a) -> float:
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    return float(np.abs(np.asarray(t, np.float32)
                        - np.asarray(a, np.float32)).max())


def _splice(full: dict, pf: dict) -> dict:
    """The prefill cache (S < the decode cache's slots, no wrap) in the
    first slots of the decode cache; states of one shape are copied."""
    out = {}
    for k, f in full.items():
        f = np.array(f)
        p = np.asarray(pf[k])
        if f.shape == p.shape:
            out[k] = p.copy()
        else:
            f[:, :, :p.shape[2]] = p
            out[k] = f
    return out


@pytest.mark.parametrize("arch", ["yi-6b", "hymba-1.5b"])
def test_prefill_and_decode_steps_match_jax(arch):
    cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                         compute_dtype="float32")
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh_context(mesh):
        jpf = jax_prefill_step(cfg, mesh, B, S)
        jdec = jax_decode_step(cfg, mesh, B, CACHE_LEN)
        jcache, jlogits = jpf.fn(jp, jnp.asarray(tokens))
    tpf = make_prefill_step(tcfg, B, S, device="cpu")
    tdec = make_decode_step(tcfg, B, CACHE_LEN, device="cpu")
    assert tpf.microbatches == tdec.microbatches == 1
    tcache, tlogits = tpf.fn(tp, tokens)
    assert tuple(tlogits.shape) == jlogits.shape == (B, cfg.vocab)
    assert _err(tlogits, jlogits) <= TOL
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == jcache[name].shape, name
        assert _err(tcache[name], jcache[name]) <= TOL, name

    empty = jax.tree.map(np.asarray, jm.init_cache(cfg, B, CACHE_LEN))
    jc = {k: jnp.asarray(v) for k, v in _splice(empty, jcache).items()}
    tc = {k: torch.from_numpy(v) for k, v in _splice(
        empty, {k: v.numpy() for k, v in tcache.items()}).items()}
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for i in range(STEPS):
        with mesh_context(mesh):
            jc, jl = jdec.fn(jp, jc, jnp.asarray(tok), jnp.int32(S + i))
        before = {k: v for k, v in tc.items()}
        tc, tl = tdec.fn(tp, tc, tok, S + i)
        assert all(tc[k] is before[k] for k in before)     # in place
        assert tuple(tl.shape) == jl.shape
        assert _err(tl, jl) <= TOL, i
        for name in jc:
            assert _err(tc[name], jc[name]) <= TOL, (i, name)
        tok = np.asarray(jnp.argmax(jl[:, :cfg.vocab], axis=-1)) \
            .astype(np.int32)


def test_steps_refuse_inputs_of_other_shapes():
    cfg = ModelConfig(**dataclasses.asdict(get_smoke_config("yi-6b")))
    from repro_torch.models import init_cache, init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="built for"):
        make_prefill_step(cfg, B, S, "cpu").fn(
            params, np.zeros((B, S + 1), np.int32))
    step = make_decode_step(cfg, B, CACHE_LEN, "cpu").fn
    with pytest.raises(ValueError, match="built for"):
        step(params, init_cache(cfg, B, CACHE_LEN + 1, "cpu"),
             np.zeros(B, np.int32), 0)
    with pytest.raises(ValueError, match="built for"):
        step(params, init_cache(cfg, B, CACHE_LEN, "cpu"),
             np.zeros(B + 1, np.int32), 0)
