"""MoE dispatch of the port against the JAX package's ``repro/models/moe.py``
on the same numpy inputs: the reference's own cases (``tests/test_moe.py``:
against the dense oracle, capacity drops, normalised gates, tight capacity)
run on both packages, plus the decode-sized drops and granite-moe-3b's
routing (40 experts, top-8) in bf16.

Tolerances:
* f32: 1e-5 abs on gates, aux and ``moe_ffn``'s output (the frameworks sum
  the router and expert products in other orders); 1e-4 abs against the
  dense oracle, as the reference's test; ``slot``, ``keep``, ``token`` and
  the chosen experts exactly.
* bf16 (granite's routing): routing exactly; the output within 3e-2 abs,
  four bf16 ulps at |out| ~ 1 (XLA and torch round bf16 activations at
  other points; observed 0.0078).
* the gather-back: bit for bit against the JAX code's scatter-add, in bf16.
* mixtral-8x7b's moe blocks in bf16, each fed the JAX block's input: 0.1
  abs on hidden states and caches, as the dense models' bf16 logits in
  tests/test_torch_models.py (observed: one ulp, 0.0156); the aux 1e-5.
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
from repro.models import blocks as jb  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import embed_tokens  # noqa: E402
from repro_torch.convert import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import _unstack  # noqa: E402

F32_TOL = 1e-5
ORACLE_TOL = 1e-4
BF16_TOL = 3e-2
BLOCK_BF16_TOL = 0.1


def _weights(seed, T, E, d, f):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, d)).astype(np.float32),
            (rng.standard_normal((d, E)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
            (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
            (rng.standard_normal((E, f, d)) * f ** -0.5).astype(np.float32))


def _both(arrays, dtype=np.float32):
    """The same values as JAX arrays and as CPU tensors; the router stays
    f32, as the blocks keep it."""
    jx = [jnp.asarray(a, jnp.float32 if i == 1 else dtype)
          for i, a in enumerate(arrays)]
    tx = [tensor_from_numpy(np.asarray(a)) for a in jx]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("T,d,E,k,f", [(64, 16, 4, 2, 32), (128, 8, 8, 1, 16),
                                       (96, 32, 8, 8, 8)])
def test_moe_matches_dense_reference(T, d, E, k, f):
    (jx, jr, jg, ju, jd), (x, r, g, u, dn) = _both(_weights(0, T, E, d, f))
    # capacity_factor big enough that nothing drops
    out, aux = tmoe.moe_ffn(x, r, g, u, dn, top_k=k,
                            capacity_factor=float(E))
    ref, aux_ref = tmoe.moe_ffn_reference(x, r, g, u, dn, top_k=k)
    assert np.abs(_np(out) - _np(ref)).max() < ORACLE_TOL
    assert abs(float(aux) - float(aux_ref)) < F32_TOL
    jref, jaux = jmoe.moe_ffn_reference(jx, jr, jg, ju, jd, top_k=k)
    assert np.abs(_np(ref) - _np(jref)).max() <= F32_TOL
    assert abs(float(aux_ref) - float(jaux)) <= F32_TOL


@pytest.mark.parametrize("T,E,k,cf", [(64, 4, 2, 1.25), (64, 4, 2, 1.0),
                                      (4, 8, 2, 1.25), (2, 4, 2, 1.25),
                                      (96, 8, 8, 1.25)])
def test_route_dispatch_and_moe_ffn_match_jax(T, E, k, cf):
    """f32, at training and decode sizes: T 4 with 8 experts top-2 is
    mixtral's decode at batch 4, capacity 1, so most assignments drop."""
    d, f = 16, 32
    (jx, jr, jg, ju, jd), (x, r, g, u, dn) = _both(_weights(1, T, E, d, f))
    jgate, jexp, jaux = jmoe.route(jx, jr, k)
    gate, experts, aux = tmoe.route(x, r, k)
    assert np.array_equal(experts.numpy(), np.asarray(jexp))
    assert np.abs(_np(gate) - _np(jgate)).max() <= F32_TOL
    assert abs(float(aux) - float(jaux)) <= F32_TOL
    capacity = max(1, int(T * k * cf / E))
    want = jmoe.dispatch_indices(jexp, E, capacity)
    got = tmoe.dispatch_indices(experts, E, capacity)
    for w, h in zip(want, got):
        assert np.array_equal(h.numpy(), np.asarray(w))
    if T * k > E * capacity:
        assert not bool(got[1].all())          # something was dropped
    jout, jaux2 = jmoe.moe_ffn(jx, jr, jg, ju, jd, top_k=k,
                               capacity_factor=cf)
    out, aux2 = tmoe.moe_ffn(x, r, g, u, dn, top_k=k, capacity_factor=cf)
    assert out.shape == (T, d) and out.dtype == torch.float32
    assert np.abs(_np(out) - _np(jout)).max() <= F32_TOL
    assert abs(float(aux2) - float(jaux2)) <= F32_TOL


def test_dispatch_capacity_drops():
    """Over-capacity tokens must be dropped, never mis-routed, and exactly
    as the reference drops them."""
    experts = np.array([[0], [0], [0], [1]])       # 3 tokens to expert 0
    slot, keep, token = tmoe.dispatch_indices(torch.from_numpy(experts),
                                              n_experts=2, capacity=2)
    kept_e0 = int(torch.sum(keep & (slot // 2 == 0)))
    assert kept_e0 == 2                              # capacity enforced
    assert bool(keep[3])                             # expert 1 kept
    want = jmoe.dispatch_indices(jnp.asarray(experts, jnp.int32), 2, 2)
    for w, h in zip(want, (slot, keep, token)):
        assert np.array_equal(h.numpy(), np.asarray(w))


def test_router_weights_normalized():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    wr = rng.standard_normal((16, 4)).astype(np.float32)
    gate, experts, aux = tmoe.route(torch.from_numpy(x),
                                    torch.from_numpy(wr), top_k=2)
    assert np.allclose(gate.sum(-1).numpy(), 1.0, atol=1e-5)
    # E * sum(f*p) = 1 only when the dispatch fraction equals the softmax
    # mass; hard top-k assignments skew them apart a few percent
    assert float(aux) >= 0.95
    jgate, _, jaux = jmoe.route(jnp.asarray(x), jnp.asarray(wr), 2)
    assert np.abs(gate.numpy() - np.asarray(jgate)).max() <= F32_TOL
    assert abs(float(aux) - float(jaux)) <= F32_TOL


def test_top_k_ties_go_to_the_lower_expert():
    """Equal probabilities: ``jax.lax.top_k`` picks the lower index first."""
    x = np.zeros((3, 4), np.float32)
    wr = np.zeros((4, 6), np.float32)
    _, experts, _ = tmoe.route(torch.from_numpy(x), torch.from_numpy(wr), 3)
    _, jexp, _ = jmoe.route(jnp.asarray(x), jnp.asarray(wr), 3)
    assert np.array_equal(experts.numpy(), np.asarray(jexp))
    assert experts.tolist() == [[0, 1, 2]] * 3


def test_moe_drop_degrades_gracefully():
    """With tight capacity the output is still finite, and the reference's."""
    T, d, E, k, f = 128, 16, 4, 2, 32
    (jx, jr, jg, ju, jd), (x, r, g, u, dn) = _both(_weights(3, T, E, d, f))
    out, _ = tmoe.moe_ffn(x, r, g, u, dn, top_k=k, capacity_factor=1.0)
    assert np.all(np.isfinite(out.numpy()))
    jout, _ = jmoe.moe_ffn(jx, jr, jg, ju, jd, top_k=k, capacity_factor=1.0)
    assert np.abs(out.numpy() - np.asarray(jout)).max() <= F32_TOL


@pytest.mark.parametrize("T", [64, 4])
def test_granite_routing_in_bf16_matches_jax(T):
    """granite-moe-3b-a800m's router: 40 experts, top-8, bf16 activations
    and expert weights, at a prefill and a decode size."""
    d, E, k, f = 32, 40, 8, 16
    arrays = _weights(4, T, E, d, f)
    (jx, jr, jg, ju, jd), (x, r, g, u, dn) = _both(arrays, jnp.bfloat16)
    assert x.dtype == torch.bfloat16 and r.dtype == torch.float32
    _, jexp, _ = jmoe.route(jx, jr, k)
    _, experts, _ = tmoe.route(x, r, k)
    assert np.array_equal(experts.numpy(), np.asarray(jexp))
    capacity = max(1, int(T * k * 1.25 / E))
    for w, h in zip(jmoe.dispatch_indices(jexp, E, capacity),
                    tmoe.dispatch_indices(experts, E, capacity)):
        assert np.array_equal(h.numpy(), np.asarray(w))
    jout, jaux = jmoe.moe_ffn(jx, jr, jg, ju, jd, top_k=k)
    out, aux = tmoe.moe_ffn(x, r, g, u, dn, top_k=k)
    assert out.dtype == torch.bfloat16
    assert np.abs(_np(out) - _np(jout)).max() <= BF16_TOL
    assert abs(float(aux) - float(jaux)) <= F32_TOL


def test_gather_back_sums_k_contributions_in_index_order():
    """The k weighted expert outputs of a token are summed left to right in
    bf16, bit for bit the JAX code's ``zeros.at[token].add(weighted)``; a
    sum in another order or in f32 gives other bits."""
    T, k, d = 16, 8, 64
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((T * k, d))
         * 2.0 ** rng.integers(-9, 3, (T * k, 1))).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16)
    token = jnp.arange(T * k) // k
    want = np.asarray(jnp.zeros((T, d), jnp.bfloat16).at[token].add(jw)
                      .astype(jnp.float32))
    tw = tensor_from_numpy(np.asarray(jw)).reshape(T, k, d)
    got = tmoe.sum_contributions(tw)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), want)
    in_f32 = tw.float().sum(1).to(torch.bfloat16)
    reverse = tmoe.sum_contributions(tw.flip(1))
    assert not np.array_equal(_np(in_f32), want)
    assert not np.array_equal(_np(reverse), want)


_PSUM_JAX = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.models.moe import moe_ffn
from repro.sharding.ctx import shard_map_fn
w = np.load(IN)
mesh = jax.make_mesh((2,), ("model",))
body = lambda x, r, g, u, d: moe_ffn(x, r, g, u, d, top_k=2,
                                     capacity_factor=2.0, psum_axis="model")
kw = dict(mesh=mesh, in_specs=(P(), P(), P(None, None, "model"),
                               P(None, None, "model"), P(None, "model")),
          out_specs=(P(), P()))
try:
    fn = shard_map_fn()(body, check_rep=False, **kw)
except TypeError:
    fn = shard_map_fn()(body, check_vma=False, **kw)
out, aux = jax.jit(fn)(*(jnp.asarray(w[k]) for k in "xrgud"))
np.savez(OUT, out=np.asarray(out), aux=np.asarray(aux))
"""

_PSUM_PORT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch.local_ranks import join_from_env
rank, world = join_from_env(timeout_s=60)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.moe import moe_ffn
from repro_torch.sharding import activation_ctx
w = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[1]).items()}
mesh = make_mesh((2,), ("model",), device="cpu")
f = w["g"].shape[-1] // 2
part = slice(rank * f, (rank + 1) * f)
with activation_ctx({}, mesh):
    out, aux = moe_ffn(w["x"], w["r"], w["g"][..., part], w["u"][..., part],
                       w["d"][:, part], top_k=2, capacity_factor=2.0,
                       psum_axis="model")
np.savez(f"{sys.argv[2]}{rank}.npz", out=out.numpy(), aux=aux.numpy())
"""


def test_psum_axis_sums_w_down_over_the_mesh_as_jax_shard_map(tmp_path):
    """``psum_axis="model"``: expert hidden dims split over 2 ranks (the
    port's gloo ranks, JAX's ``shard_map`` on 2 forced host devices); both
    ranks' outputs equal JAX's, and the one-device ``moe_ffn`` on the whole
    weights, within the f32 tolerance."""
    import os
    import subprocess
    import sys
    from repro_torch.launch.local_ranks import spawn_ranks
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    x, r, g, u, dn = _weights(11, 12, 4, 8, 16)
    np.savez(tmp_path / "w.npz", x=x, r=r, g=g, u=u, d=dn)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    code = f"IN, OUT = {str(tmp_path / 'w.npz')!r}, " \
        f"{str(tmp_path / 'jax.npz')!r}\n" + _PSUM_JAX
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    script = tmp_path / "port.py"
    script.write_text(_PSUM_PORT)
    env.pop("XLA_FLAGS")
    spawn_ranks(2, [sys.executable, str(script), str(tmp_path / "w.npz"),
                    str(tmp_path / "port")], str(tmp_path / "ranks"), 120, env)
    want = np.load(tmp_path / "jax.npz")
    whole, _ = tmoe.moe_ffn(*(torch.from_numpy(a) for a in (x, r, g, u, dn)),
                            top_k=2, capacity_factor=2.0)
    for rank in range(2):
        got = np.load(tmp_path / f"port{rank}.npz")
        assert np.abs(got["out"] - want["out"]).max() <= F32_TOL
        assert abs(float(got["aux"]) - float(want["aux"])) <= F32_TOL
        assert np.abs(got["out"] - whole.numpy()).max() <= F32_TOL


def test_bf16_moe_blocks_match_jax_layer_by_layer():
    """mixtral-8x7b in bf16, each block (prefill apply, and the first
    decode steps from an empty cache, capacity 1) fed the JAX block's own
    input and cache, and the JAX blocks run op by op, so every router sees
    the bits the other package's saw. End to end, bf16 top-k routing is not a function two
    programs can agree on: XLA's CPU ``silu`` rounds otherwise than
    torch's (one bf16 ulp in ~40% of elements), that moves a router logit
    by ~1e-3, and where two experts are that close the next layer picks
    another one. On this smoke config a 7e-4 margin at layer 1 moves a
    logit by 0.58; the JAX block jitted against the same block op by op
    differs by 0.52 for the same reason."""
    cfg = get_smoke_config("mixtral-8x7b")          # bf16 params and compute
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tps = _unstack(params_from_jax(jax.tree.map(np.asarray, jp),
                                   "cpu")["blocks"])
    jps = [jax.tree.map(lambda a, i=i: a[i], jp["blocks"])
           for i in range(cfg.n_layers)]
    B, S, steps = 2, 24, 8
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))

    def t(a):
        return tensor_from_numpy(np.asarray(a))

    def close(got, want, tol=BLOCK_BF16_TOL):
        return np.abs(_np(got) - _np(want)).max() <= tol

    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    x = embed_tokens(cfg, jp, toks)
    with torch.inference_mode():
        for jpi, tpi in zip(jps, tps):
            jx, jaux, jcache = jb.apply_block(cfg, jpi, x, pos, True)
            tx, taux, tcache = tb.apply_moe_block(tcfg, tpi, t(x), t(pos),
                                                  True)
            assert tx.dtype == torch.bfloat16 and close(tx, jx)
            assert abs(float(taux) - float(jaux)) <= F32_TOL
            assert all(close(tcache[k], jcache[k]) for k in jcache)
            x = jx
        cache = jm.init_cache(cfg, B, S + 4)
        for step in range(steps):
            x = embed_tokens(cfg, jp, toks[:, step])
            for i, (jpi, tpi) in enumerate(zip(jps, tps)):
                ci = {k: v[i] for k, v in cache.items()}
                jc, jx = jb.decode_block(cfg, jpi, ci, x, jnp.int32(step))
                tcache, tx = tb.decode_moe_block(
                    tcfg, tpi, {k: t(v) for k, v in ci.items()}, t(x), step)
                assert close(tx, jx), (step, i)
                assert all(close(tcache[k], jc[k]) for k in jc)
                cache = {k: v.at[i].set(jc[k]) for k, v in cache.items()}
                x = jx
